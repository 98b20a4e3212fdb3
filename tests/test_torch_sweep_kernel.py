"""The sweep's plane scan in its two forms (``ops/sweep_render.py``) and
the kernels' wrapper (``kernels/sweep_scan.py``), at the scenes of
tests/test_torch_sweep.py (a 16^3 smoke cloud, an 8^3 light volume, 32
planes) and tests/test_torch_grad.py (a 12^2 image at sampling rate 1.5):

- ``method`` dispatch: "auto" on CPU tensors runs the plain loop and
  launches nothing; "cuda" on CPU tensors and an unknown method raise; the
  wrapper refuses CPU tensors;
- ``scan_constants`` against the reference's schedule and its inline slab
  lerp (``cpm_tpu/ops/sweep_render.py:225-236``), and its per-plane
  counts of non-finite texels against the lerped slabs;
- non-finite texels: the reference's ``sweep_render`` on a light volume
  with +inf texels gives NaN at the same pixels as the plain loop (its
  hat-matrix products meet every texel with every ray), and the kernel's
  rule (NaN where a plane holds more non-finite texels than the sample's
  own taps read), run here in torch, classifies every sample of the plain
  loop's products as NaN, infinite or finite as they do;
- the backward's plain version ``_scan_planes_grad_torch`` (the closed-form
  recurrence the backward kernel runs) against autograd through
  ``_scan_planes_torch``, and, put in the scan's place through an autograd
  function, against ``jax.grad`` of the reference's ``sweep_render``: the
  volume, the light volume and the TF's colours and positions, at the
  default sweep, the eye inside, a column slice and a volume region that
  sits exactly on a TF point;
- transfer functions of any size: the plain loop and its backward at 17
  and 64 points against the reference's ``_scan_planes`` and ``jax.grad``
  of it; the kernels' rule for the TF (the last segment with
  ``x >= pos[s]`` found by compares, then that one segment's lerp), run
  here in torch, equal bit for bit to ``TransferFunction.sample`` at 1 to
  256 points, unsorted and tied ones, NaN and infinities included;
- the forward's plane pre-pass: its plain version
  (``kernels/sweep_scan._prepare_planes_torch``) against the reference's
  per-plane slabs and ``_hat_matrix``'s nonzero taps, and the chunk plan
  (planes under a byte budget) as a pure function;
- on the card (marked ``cuda``): each kernel against its plain version,
  the forward also on volumes with +inf texels, NaN equal, both at 17, 64
  and 256 TF points; the pre-pass bit for bit; a forward in four chunks
  bit for bit against one chunk; the backward (pre-pass, gradient march
  and fold, one launch of each a chunk) with its TF table in device
  memory, in four chunks against one chunk, and its fold bit for bit
  against the fold's plain version on the gradient march's own planes.

Tolerances: values to rtol 1e-5; gradients to rtol 1e-4 with an absolute
floor of 1e-5 of the largest component (float32 sums in another order:
tests/test_torch_grad.py's); on the card the forward to rtol 1e-4, atol
1e-6 of the largest value (the plain loop samples through torch.matmul)
and the backward to rtol 1e-3, atol 1e-5 of the largest component
(atomics reorder its sums).

The reference is imported inside the tests that use it, so that the card
tests also run where JAX is not installed (``--noconftest``).
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from cpm_tpu_torch.core import camera as tcamera
from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import RenderConfig
from cpm_tpu_torch.io import synthetic
from cpm_tpu_torch.kernels import sweep_scan as ss
from cpm_tpu_torch.ops import sweep_render as tsw

VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
CARD_RTOL, CARD_ATOL_REL = 1e-4, 1e-6
CARD_GRAD_RTOL, CARD_GRAD_ATOL_REL = 1e-3, 1e-5

DIM, LV_DIM = 16, 8
# tests/test_torch_grad.py's TF; TIE_POS has an interior point at 0.5,
# where the TIE case's volume region sits.
TF_POS = np.array([0.0, 0.25, 0.6, 1.0], np.float32)
TIE_POS = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
TF_COLS = np.array([[0.1, 0.2, 0.3, 0.05], [0.4, 0.5, 0.3, 0.3],
                    [0.9, 0.7, 0.5, 0.6], [1.0, 1.0, 1.0, 0.9]], np.float32)
EYE = (0.45, 0.6, -1.5)
CENTER = (0.5, 0.5, 0.5)
CASES = {
    "default": dict(eye=EYE, center=CENTER, tf=TF_POS,
                    render=dict(width=12, height=12, sampling_rate=1.5)),
    # tests/test_torch_sweep.py's eye-inside render (at 12^2 the port's
    # warp draws the last row, which the reference's leaves empty: the
    # intermediate images agree, ROADMAP queue 3).
    "eye inside": dict(eye=(0.5, 0.55, 0.3), center=(0.5, 0.5, 0.9),
                       tf=TF_POS, render=dict(width=24, height=24,
                                              sampling_rate=2.0)),
    "on a TF point": dict(eye=(2.0, 0.4, 0.5), center=CENTER, tf=TIE_POS,
                          tie=True, render=dict(width=12, height=12,
                                                sampling_rate=1.5)),
}
SCAN = dict(n_planes=32, inter_u=40, inter_v=36, width=24, height=24,
            ambient=0.05)
COLUMNS = slice(7, 29)  # a rank's columns of the 40


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread beside JAX's pool (tests/test_torch_emission.py
    measured ~8x on this box's cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(tie: bool = False) -> np.ndarray:
    """tests/test_torch_grad.py's volume; with ``tie`` a block of it set to
    0.5, which a trilinear sample inside the block reproduces exactly."""
    data = synthetic.smoke_cloud(DIM, seed=5)
    if tie:
        data = data.copy()
        data[3:13, 4:12, 2:14] = 0.5
    return data


def _light(seed: int = 2) -> np.ndarray:
    lv = np.random.default_rng(seed).uniform(0.0, 2.0, (LV_DIM,) * 3 + (3,))
    return lv.astype(np.float32)


def _scan_inputs(eye=EYE, center=CENTER, columns=slice(None), tie=False,
                 device="cpu", pos=TF_POS, cols=TF_COLS):
    """The permuted volumes, TF, schedule and rays of one sweep of
    ``SCAN``'s size along the camera's principal axis, on ``device``."""
    cam = tcamera.Camera.create(eye=eye, center=center, device=device)
    axis, sign = tsw.principal_axis(cam)
    data = torch.from_numpy(_data(tie)).to(device)
    light = torch.from_numpy(_light()).to(device)
    vol_p, light_p = tsw.permute_volumes(data, light, axis)
    tf = ttypes.TransferFunction.from_points(pos, cols, device=device)
    sched = tsw._plane_schedule(cam, axis, sign, SCAN["n_planes"],
                                SCAN["width"], SCAN["height"])
    u, v = tsw.base_grid(sched, SCAN["inter_u"], SCAN["inter_v"])
    return vol_p, light_p, tf, sched, u[columns], v


class PlainScan(torch.autograd.Function):
    """The plain loop with the backward's plain version as its gradient:
    what ``kernels/sweep_scan.SweepScan`` is on the card, in plain torch."""

    @staticmethod
    def forward(ctx, vol_p, light_p, pos, cols, c, u, v, ambient):
        tf = ttypes.TransferFunction(positions=pos, colors=cols, lut=None)
        out = tsw._scan_planes_torch(vol_p, light_p, tf, c, u, v, ambient)
        ctx.save_for_backward(vol_p, light_p, pos, cols, u, v, out)
        ctx.c, ctx.ambient = c, ambient
        return out

    @staticmethod
    def backward(ctx, grad_out):
        vol_p, light_p, pos, cols, u, v, out = ctx.saved_tensors
        tf = ttypes.TransferFunction(positions=pos, colors=cols, lut=None)
        grads = tsw._scan_planes_grad_torch(vol_p, light_p, tf, ctx.c, u, v,
                                            ctx.ambient, out,
                                            grad_out.contiguous())
        return (*grads, None, None, None, None)


def _plain_scan(vol_p, light_p, tf, sched, u, v, ambient, method="auto"):
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    return PlainScan.apply(vol_p, light_p, tf.positions, tf.colors, c, u, v,
                           ambient)


def _close(got, want, rtol, atol_rel, what):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want.detach().cpu() if torch.is_tensor(want) else want)
    assert np.abs(want).max() > 0.0, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(),
                               err_msg=what)


# --- dispatch ---------------------------------------------------------------

def test_auto_on_cpu_runs_the_plain_loop_and_launches_nothing():
    vol_p, light_p, tf, sched, u, v = _scan_inputs()
    before = (telemetry.launches("sweep_scan_forward"),
              telemetry.launches("sweep_scan_backward"))
    got = tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    want = tsw._scan_planes_torch(vol_p, light_p, tf, c, u, v, 0.05)
    assert torch.equal(got, want)
    assert float(got[..., 3].max()) > 0.05
    assert (telemetry.launches("sweep_scan_forward"),
            telemetry.launches("sweep_scan_backward")) == before


@pytest.mark.parametrize("method", ["cuda", "triton", "kernel", ""])
def test_cuda_on_cpu_tensors_and_unknown_methods_raise(method):
    vol_p, light_p, tf, sched, u, v = _scan_inputs()
    with pytest.raises(ValueError):
        tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05,
                         method=method)


def test_the_wrapper_refuses_cpu_tensors():
    vol_p, light_p, tf, sched, u, v = _scan_inputs()
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    before = telemetry.launches("sweep_scan_forward")
    with pytest.raises(ValueError, match="CUDA"):
        ss.sweep_scan(vol_p, light_p, tf.positions, tf.colors, c, u, v, 0.05)
    with pytest.raises(ValueError, match="CUDA"):
        ss.sweep_scan_forward(vol_p, light_p, tf.positions, tf.colors, c, u,
                              v, 0.05)
    out = torch.zeros((v.shape[0], u.shape[0], 4))
    with pytest.raises(ValueError, match="CUDA"):
        ss.sweep_scan_backward(vol_p, light_p, tf.positions, tf.colors, c, u,
                               v, 0.05, out, out)
    assert telemetry.launches("sweep_scan_forward") == before


def test_the_wrappers_arguments_mirror_the_sources_struct():
    """``kernels/sweep_scan._Args`` holds the fields of ``struct ScanArgs``
    in csrc/sweep_scan.cu, in order and each once, with C's types."""
    import re

    body = re.search(r"struct ScanArgs \{(.*?)\n\};", ss.SOURCE.read_text(),
                     re.S).group(1)
    want = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            kind = ("ptr" if "*" in decl else "int" if decl.startswith("int")
                    else "float")
            names = (decl.split("*", 1)[1] if kind == "ptr"
                     else decl.split(None, 1)[1])
            want += [(name.strip(), kind) for name in names.split(",")]
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    got = [(name, kinds[t]) for name, t in ss._Args._fields_]
    assert got == want
    assert len({name for name, _ in got}) == len(got)


# --- the constants against the reference -------------------------------------

@pytest.mark.parametrize("eye", [EYE, (2.0, 0.4, 0.5), (0.5, 0.55, 0.3)])
def test_scan_constants_match_the_reference(eye):
    import jax.numpy as jnp

    from cpm_tpu.core import camera as jcamera
    from cpm_tpu.ops import sweep_render as jsw

    vol_p, light_p, tf, sched, u, v = _scan_inputs(eye=eye)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    jcam = jcamera.Camera.create(eye=eye, center=CENTER)
    axis, sign = jsw.principal_axis(jcam)
    js = jsw._plane_schedule(jcam, axis, sign, SCAN["n_planes"],
                             SCAN["width"], SCAN["height"])
    ju, jv = jsw.base_grid(js, SCAN["inter_u"], SCAN["inter_v"])
    for na, (k0, k1, fz) in ((vol_p.shape[0], (c.k0, c.k1, c.fz)),
                             (light_p.shape[0], (c.lk0, c.lk1, c.lfz))):
        zf = jnp.clip(js.za * na - 0.5, 0.0, na - 1.0)
        jk0 = jnp.floor(zf).astype(jnp.int32)
        np.testing.assert_array_equal(k0.numpy(), np.asarray(jk0))
        np.testing.assert_array_equal(
            k1.numpy(), np.asarray(jnp.minimum(jk0 + 1, na - 1)))
        np.testing.assert_allclose(
            fz.numpy(), np.asarray(zf - jk0.astype(jnp.float32)), atol=1e-6)
    np.testing.assert_array_equal(c.valid.numpy(),
                                  np.asarray(js.valid).astype(np.float32))
    np.testing.assert_allclose(c.w_planes.numpy(), np.asarray(js.w_planes),
                               rtol=1e-6)
    dl = (1.0 / SCAN["n_planes"]) * jnp.sqrt(
        (ju[None, :] - js.o_b) ** 2 + (jv[:, None] - js.o_c) ** 2
        + js.depth0 ** 2) / jnp.maximum(js.depth0, 1e-6)
    np.testing.assert_allclose(c.dl.numpy(), np.asarray(dl), rtol=1e-6)
    for got, want in ((c.o_b, js.o_b), (c.o_c, js.o_c)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
    assert c.sbi == pytest.approx(float(np.float32(
        jsw.constants.SAMPLING_BASE_INTERVAL_RCP)))


# --- non-finite texels ----------------------------------------------------

def _with_inf(t: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """``t`` with +inf at ``n`` seeded elements and at its last one (a
    texel that the edge clamp reaches)."""
    t = t.clone()
    idx = np.random.default_rng(seed).choice(t.numel(), n, replace=False)
    t.view(-1)[torch.from_numpy(idx)] = float("inf")
    t.view(-1)[-1] = float("inf")
    return t


def test_scan_constants_count_the_nonfinite_texels_of_each_plane():
    vol_p, light_p, tf, sched, u, v = _scan_inputs()
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    assert int(c.nonfinite.abs().sum()) == int(c.lnonfinite.abs().sum()) == 0
    vol_p, light_p = _with_inf(vol_p, 40, 0), _with_inf(light_p, 20, 1)
    vol_p.view(-1)[7] = float("nan")
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    assert c.nonfinite.dtype == c.lnonfinite.dtype == torch.int32
    for k in range(c.fz.shape[0]):
        slab = (1.0 - c.fz[k]) * vol_p[c.k0[k]] + c.fz[k] * vol_p[c.k1[k]]
        lslab = ((1.0 - c.lfz[k]) * light_p[c.lk0[k]]
                 + c.lfz[k] * light_p[c.lk1[k]])
        assert int(c.nonfinite[k]) == int((~torch.isfinite(slab)).sum())
        assert c.lnonfinite[k].tolist() == (~torch.isfinite(lslab)).sum(
            (0, 1)).tolist()
    assert int(c.lnonfinite.sum()) > 0


def _kernel_taps(slab, hc, hb, bad):
    """The forward kernel's trilinear value (``tap_sum`` in
    csrc/sweep_scan.cu), in torch: ``slab`` (Nc, Nb, C) lerped, the hat
    rows of the (V,) and (U,) coordinates ``hc``, ``hb``, the plane's
    non-finite counts ``bad`` (C,) -> (V, U, C)."""
    def taps(x, n):
        f = torch.clamp(x * n - 0.5, 0.0, n - 1.0)
        f0 = torch.floor(f)
        i0 = f0.to(torch.int64)
        i1 = torch.clamp(i0 + 1, max=n - 1)
        w0 = torch.clamp(1.0 - torch.abs(f - f0), min=0.0)
        w1 = torch.clamp(1.0 - torch.abs(f - (f0 + 1.0)), min=0.0)
        return i0, i1, w0, w1, i1 == i0

    (r0, r1, rw0, rw1, one_r), (c0, c1, cw0, cw1, one_c) = (
        taps(hc, slab.shape[0]), taps(hb, slab.shape[1]))
    one_r, one_c = one_r[:, None, None], one_c[None, :, None]
    at = slab[r0[:, None], c0[None, :]], slab[r1[:, None], c0[None, :]]
    bt = slab[r0[:, None], c1[None, :]], slab[r1[:, None], c1[None, :]]
    zero = torch.zeros(())
    a10 = torch.where(one_r, zero, at[1])
    a01 = torch.where(one_c, zero, bt[0])
    a11 = torch.where(one_r | one_c, zero, bt[1])
    w = (rw0[:, None, None], rw1[:, None, None], cw0[None, :, None],
         cw1[None, :, None])
    col0 = torch.where(one_r, w[0] * at[0], w[0] * at[0] + w[1] * a10)
    col1 = torch.where(one_r, w[0] * a01, w[0] * a01 + w[1] * a11)
    val = torch.where(one_c, w[2] * col0, w[2] * col0 + w[3] * col1)
    read = sum((~torch.isfinite(t)).to(torch.int32)
               for t in (at[0], a10, a01, a11))
    return torch.where(bad > read, torch.nan, val)


@pytest.mark.parametrize("eye", [EYE, (2.0, 0.4, 0.5), (0.5, 0.55, 0.3)])
def test_the_kernels_nan_rule_classifies_like_the_products(eye):
    """Every sample of every plane: the kernel's taps with its NaN rule are
    NaN, infinite or finite where the plain loop's hat-matrix products
    are, for the light volume's channels and the volume."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(eye=eye)
    vol_p, light_p = _with_inf(vol_p, 12, 2), _with_inf(light_p, 6, 3)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    kinds = {"nan": 0, "inf": 0, "finite": 0}
    for k in range(c.fz.shape[0]):
        b_k = c.o_b + c.w_planes[k] * (u - c.o_b)
        c_k = c.o_c + c.w_planes[k] * (v - c.o_c)
        lslab = ((1.0 - c.lfz[k]) * light_p[c.lk0[k]]
                 + c.lfz[k] * light_p[c.lk1[k]])
        slab = (1.0 - c.fz[k]) * vol_p[c.k0[k]] + c.fz[k] * vol_p[c.k1[k]]
        nc2, nb2 = lslab.shape[:2]
        nc, nb = slab.shape
        for got, want in (
                (_kernel_taps(lslab, c_k, b_k, c.lnonfinite[k]),
                 torch.einsum("vc,cbk,ub->vuk", tsw._hat_matrix(c_k, nc2),
                              lslab, tsw._hat_matrix(b_k, nb2))),
                (_kernel_taps(slab[..., None], c_k, b_k,
                              c.nonfinite[k:k + 1])[..., 0],
                 (tsw._hat_matrix(c_k, nc) @ slab)
                 @ tsw._hat_matrix(b_k, nb).T)):
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert torch.equal(torch.isinf(got), torch.isinf(want))
            kinds["nan"] += int(torch.isnan(want).sum())
            kinds["inf"] += int(torch.isinf(want).sum())
            kinds["finite"] += int(torch.isfinite(want).sum())
    assert min(kinds.values()) > 0, kinds


def test_the_reference_spreads_nan_as_the_plain_loop_does():
    """A light volume with +inf texels (as a float16 trace stores them):
    the reference's ``sweep_render`` and the port's plain loop give NaN at
    the same pixels, and agree on the others."""
    import jax.numpy as jnp

    from cpm_tpu.core.camera import Camera as JCamera
    from cpm_tpu.core.config import RenderConfig as JRenderConfig
    from cpm_tpu.core.types import TransferFunction as JTF
    from cpm_tpu.core.types import Volume as JVolume
    from cpm_tpu.ops import sweep_render as jsw

    spec = CASES["default"]
    data = _data()
    light = _with_inf(torch.from_numpy(_light()), 4, 5)
    want = np.asarray(jsw.sweep_render(
        JVolume.from_data(data), JTF.from_points(TF_POS, TF_COLS),
        jnp.asarray(light.numpy()),
        JCamera.create(eye=spec["eye"], center=spec["center"]),
        JRenderConfig(**spec["render"])))
    got = tsw.sweep_render(
        ttypes.Volume.from_data(data, device="cpu"),
        ttypes.TransferFunction.from_points(TF_POS, TF_COLS, device="cpu"),
        light, tcamera.Camera.create(eye=spec["eye"], center=spec["center"],
                                     device="cpu"),
        RenderConfig(**spec["render"]), method="torch").numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    drawn = want[..., 3] > 0.0
    assert nan[..., :3].any(-1).sum() == drawn.sum() > 0
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=VALUE_RTOL,
                               atol=1e-6)


# --- the backward's plain version ------------------------------------------

def _leaves(vol_p, light_p, tf):
    return [t.detach().clone().requires_grad_(True)
            for t in (vol_p, light_p, tf.positions, tf.colors)]


@pytest.mark.parametrize("case", ["default", "eye inside", "column slice",
                                  "on a TF point"])
def test_plain_backward_matches_autograd(case):
    """``_scan_planes_grad_torch`` against autograd through the plain loop,
    for a seeded linear loss of the intermediate image. The eye inside is
    the forward sweep of the two."""
    kw = {"default": {}, "eye inside": dict(eye=(0.5, 0.55, 0.3),
                                            center=(0.5, 0.5, 0.9)),
          "column slice": dict(columns=COLUMNS),
          "on a TF point": dict(eye=(2.0, 0.4, 0.5), tie=True,
                                pos=TIE_POS)}[case]
    vol_p, light_p, tf, sched, u, v = _scan_inputs(**kw)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    leaves = _leaves(vol_p, light_p, tf)
    tf_g = ttypes.TransferFunction(positions=leaves[2], colors=leaves[3],
                                   lut=None)
    out = tsw._scan_planes_torch(leaves[0], leaves[1], tf_g, c, u, v, 0.05)
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.5, out.shape).astype(np.float32))
    want = torch.autograd.grad((out * w).sum(), leaves)
    got = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05,
                                      out.detach(), w)
    if case == "on a TF point":
        assert _samples_on(vol_p, c, u, v, 0.5) > 50
    for name, g, wg in zip(("volume", "light volume", "tf positions",
                            "tf colours"), got, want):
        _close(g, wg, GRAD_RTOL, GRAD_ATOL_REL, f"{case}: {name}")


def _samples_on(vol_p, c, u, v, value: float) -> int:
    """Samples of the scan whose trilinear value is exactly ``value``."""
    nc, nb = vol_p.shape[1:]
    s0, s1 = vol_p[c.k0], vol_p[c.k1]
    n = 0
    for k in range(c.fz.shape[0]):
        slab = (1.0 - c.fz[k]) * s0[k] + c.fz[k] * s1[k]
        b_k = c.o_b + c.w_planes[k] * (u - c.o_b)
        c_k = c.o_c + c.w_planes[k] * (v - c.o_c)
        field = (tsw._hat_matrix(c_k, nc) @ slab) @ tsw._hat_matrix(b_k, nb).T
        n += int((field == value).sum())
    return n


def _jax_case(case: str):
    """(reference loss, port loss, arguments) of the image's seeded linear
    loss for ``case`` in the light volume, the TF's positions and colours
    and the volume data."""
    import jax.numpy as jnp

    from cpm_tpu.core.camera import Camera as JCamera
    from cpm_tpu.core.config import RenderConfig as JRenderConfig
    from cpm_tpu.core.types import TransferFunction as JTF
    from cpm_tpu.core.types import Volume as JVolume
    from cpm_tpu.ops import sweep_render as jsw

    spec = CASES[case]
    data = _data(spec.get("tie", False))
    jvol = JVolume.from_data(data)
    tvol = ttypes.Volume.from_data(data, device="cpu")
    rc = spec["render"]
    w = np.random.default_rng(3).uniform(
        0.5, 1.5, (rc["height"], rc["width"], 4)).astype(np.float32)

    def jl(light, pos, cols, vol_data):
        img = jsw.sweep_render(jvol.replace(data=vol_data),
                               JTF.from_points(pos, cols), light,
                               JCamera.create(eye=spec["eye"],
                                              center=spec["center"]),
                               JRenderConfig(**rc))
        return jnp.sum(img * w)

    def tl(light, pos, cols, vol_data):
        img = tsw.sweep_render(
            dataclasses.replace(tvol, data=vol_data),
            ttypes.TransferFunction.from_points(pos, cols, device="cpu"),
            light, tcamera.Camera.create(eye=spec["eye"],
                                         center=spec["center"],
                                         device="cpu"),
            RenderConfig(**rc))
        return (img * torch.from_numpy(w)).sum()

    return jl, tl, [_light(), spec["tf"], TF_COLS, data]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_grad(case, monkeypatch):
    """The reference's ``sweep_render`` under ``jax.grad`` against the
    port's with the plane scan's gradient from ``_scan_planes_grad_torch``
    (the warp and the permutations through autograd)."""
    import jax
    import jax.numpy as jnp

    jl, tl, args = _jax_case(case)
    want = jax.grad(jl, argnums=(0, 1, 2, 3))(*[jnp.asarray(a) for a in args])
    monkeypatch.setattr(tsw, "_scan_planes", _plain_scan)
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    val = tl(*xs)
    got = torch.autograd.grad(val, xs)
    np.testing.assert_allclose(float(val.detach()), float(jl(*args)),
                               rtol=VALUE_RTOL)
    for name, g, wg in zip(("light volume", "tf positions", "tf colours",
                            "volume"), got, want):
        _close(g, wg, GRAD_RTOL, GRAD_ATOL_REL, f"{case}: {name}")


def test_plain_backward_matches_jax_grad_on_a_column_slice():
    """A rank's columns: the reference's ``_scan_planes`` on the same
    slice of its base grid under ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from cpm_tpu.core import camera as jcamera
    from cpm_tpu.core.types import TransferFunction as JTF
    from cpm_tpu.ops import sweep_render as jsw

    vol_p, light_p, tf, sched, u, v = _scan_inputs(columns=COLUMNS)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    out = tsw._scan_planes_torch(vol_p, light_p, tf, c, u, v, 0.05)
    w = np.random.default_rng(6).uniform(0.5, 1.5, out.shape).astype(
        np.float32)
    got = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05, out,
                                      torch.from_numpy(w))

    jcam = jcamera.Camera.create(eye=EYE, center=CENTER)
    axis, sign = jsw.principal_axis(jcam)
    js = jsw._plane_schedule(jcam, axis, sign, SCAN["n_planes"],
                             SCAN["width"], SCAN["height"])
    ju, jv = jsw.base_grid(js, SCAN["inter_u"], SCAN["inter_v"])

    def jl(vp, lp, pos, cols):
        inter = jsw._scan_planes(vp, lp, JTF.from_points(pos, cols), js,
                                 ju[COLUMNS], jv, 0.05)
        return jnp.sum(inter * w)

    want = jax.grad(jl, argnums=(0, 1, 2, 3))(
        jnp.asarray(vol_p.numpy()), jnp.asarray(light_p.numpy()),
        jnp.asarray(TF_POS), jnp.asarray(TF_COLS))
    np.testing.assert_allclose(
        float((out * torch.from_numpy(w)).sum()),
        float(jl(*(jnp.asarray(a) for a in (vol_p.numpy(), light_p.numpy(),
                                             TF_POS, TF_COLS)))),
        rtol=VALUE_RTOL)
    for name, g, wg in zip(("volume", "light volume", "tf positions",
                            "tf colours"), got, want):
        _close(g, wg, GRAD_RTOL, GRAD_ATOL_REL, f"column slice: {name}")


# --- transfer functions of any size --------------------------------------------

def _many_points(n: int, seed: int = 11, top: float = 0.2):
    """A seeded transfer function of ``n`` points as a TF editor makes
    them over the data's range (the test volume's values lie in [0,
    0.196]): sorted positions from 0 to ``top``, colours in [0, 1],
    opacities up to 0.9."""
    rs = np.random.default_rng(seed)
    pos = np.sort(rs.uniform(0.0, top, n)).astype(np.float32)
    pos[0], pos[-1] = 0.0, top
    cols = rs.uniform(0.0, 1.0, (n, 4)).astype(np.float32)
    cols[:, 3] *= 0.9
    return pos, cols


@pytest.mark.parametrize("points", [17, 64])
def test_plain_scan_and_backward_match_the_reference_at_many_tf_points(
        points):
    """The plain loop's intermediate image against the reference's
    ``_scan_planes``, and its backward's plain version against
    ``jax.grad`` of it, for a transfer function of ``points`` points: the
    semantics that the kernels take on."""
    import jax
    import jax.numpy as jnp

    from cpm_tpu.core import camera as jcamera
    from cpm_tpu.core.types import TransferFunction as JTF
    from cpm_tpu.ops import sweep_render as jsw

    pos, cols = _many_points(points)
    vol_p, light_p, tf, sched, u, v = _scan_inputs(pos=pos, cols=cols)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    out = tsw._scan_planes_torch(vol_p, light_p, tf, c, u, v, 0.05)
    w = np.random.default_rng(6).uniform(0.5, 1.5, out.shape).astype(
        np.float32)
    got = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05, out,
                                      torch.from_numpy(w))

    jcam = jcamera.Camera.create(eye=EYE, center=CENTER)
    axis, sign = jsw.principal_axis(jcam)
    js = jsw._plane_schedule(jcam, axis, sign, SCAN["n_planes"],
                             SCAN["width"], SCAN["height"])
    ju, jv = jsw.base_grid(js, SCAN["inter_u"], SCAN["inter_v"])

    def inter(vp, lp, p, cl):
        return jsw._scan_planes(vp, lp, JTF.from_points(p, cl), js, ju, jv,
                                0.05)

    args = [jnp.asarray(a) for a in (vol_p.numpy(), light_p.numpy(), pos,
                                     cols)]
    want_out = np.asarray(inter(*args))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=VALUE_RTOL,
                               atol=1e-6)
    assert want_out[..., 3].max() > 0.05
    want = jax.grad(lambda *a: jnp.sum(inter(*a) * w),
                    argnums=(0, 1, 2, 3))(*args)
    for name, g, wg in zip(("volume", "light volume", "tf positions",
                            "tf colours"), got, want):
        _close(g, wg, GRAD_RTOL, GRAD_ATOL_REL, f"{points} points: {name}")
    # Most segments are sampled: the gradient reaches most colour rows.
    assert (np.abs(np.asarray(want[3])).sum(1) > 0).sum() > points // 2


def _kernel_tf_sample(pos: torch.Tensor, cols: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """The kernels' transfer-function sample (``tf_sample`` in
    csrc/sweep_scan.cu), in torch: the last segment with x >= pos[s] by
    compares alone (-1 for none), then that one segment's width,
    parameter, clip and lerp; the first colour for none."""
    n = pos.shape[0]
    sel = torch.full(x.shape, -1, dtype=torch.int64)
    for s in range(n - 1):
        sel = torch.where(x >= pos[s], s, sel)
    s0 = torch.clamp(sel, min=0)
    s1 = torch.clamp(s0 + 1, max=n - 1)
    t = torch.clamp((x - pos[s0]) / torch.clamp(pos[s1] - pos[s0], min=1e-12),
                    0.0, 1.0)
    seg = cols[s0] + (cols[s1] - cols[s0]) * t[..., None]
    return torch.where((sel < 0)[..., None], cols[0], seg)


TF_RULE_CASES = {
    "1 point": (np.array([0.4], np.float32), TF_COLS[:1]),
    "2 points": (TF_POS[[0, 3]], TF_COLS[[0, 3]]),
    "17 points": _many_points(17),
    "64 points": _many_points(64),
    "256 points": _many_points(256),
    "unsorted, tied": (np.array([0.3, 0.1, 0.1, 0.7, 0.5, 0.5, 0.9, 1.0, 0.0],
                                np.float32), _many_points(9)[1]),
}


@pytest.mark.parametrize("case", list(TF_RULE_CASES))
def test_the_kernels_tf_rule_equals_the_where_chain(case):
    """One surviving segment gives TransferFunction.sample's bits: seeded
    values around the points' range, every point itself, NaN and both
    infinities."""
    pos, cols = TF_RULE_CASES[case]
    tf = ttypes.TransferFunction.from_points(pos, cols, device="cpu")
    span = max(float(pos.max() - pos.min()), 1.0)
    x = np.random.default_rng(9).uniform(
        pos.min() - 0.2 * span, pos.max() + 0.2 * span, 4096).astype(
        np.float32)
    x = torch.from_numpy(np.concatenate([x, pos, [np.nan, np.inf, -np.inf]])
                         .astype(np.float32))
    got = _kernel_tf_sample(tf.positions, tf.colors, x)
    want = tf.sample(x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


# --- the forward's plane pre-pass ------------------------------------------

@pytest.mark.parametrize("eye", [EYE, (2.0, 0.4, 0.5), (0.5, 0.55, 0.3)])
def test_prepared_planes_match_the_references_slabs_and_hat_rows(eye):
    """The pre-pass's plain version against what the reference's
    ``_scan_planes`` makes per plane (sweep_render.py:224-251): the slab
    lerps of the volume and light volume, the hat matrices (rebuilt from
    the two taps and weights of each row) and the masks; the light's pad
    is zero and the counts are the constants'."""
    import jax.numpy as jnp

    from cpm_tpu.core import camera as jcamera
    from cpm_tpu.ops import sweep_render as jsw

    vol_p, light_p, tf, sched, u, v = _scan_inputs(eye=eye)
    vol_p, light_p = _with_inf(vol_p, 5, 7), _with_inf(light_p, 3, 8)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    planes = ss._prepare_planes_torch(vol_p, light_p, c, u, v, 0,
                                      SCAN["n_planes"])
    jcam = jcamera.Camera.create(eye=eye, center=CENTER)
    axis, sign = jsw.principal_axis(jcam)
    js = jsw._plane_schedule(jcam, axis, sign, SCAN["n_planes"],
                             SCAN["width"], SCAN["height"])
    ju, jv = jsw.base_grid(js, SCAN["inter_u"], SCAN["inter_v"])
    nc, nb = vol_p.shape[1:]
    nc2, nb2 = light_p.shape[1:3]

    def slab(data, za_k):
        na = data.shape[0]
        zf = jnp.clip(za_k * na - 0.5, 0.0, na - 1.0)
        k0 = jnp.floor(zf).astype(jnp.int32)
        fz = zf - k0.astype(jnp.float32)
        return np.asarray((1.0 - fz) * data[k0]
                          + fz * data[jnp.minimum(k0 + 1, na - 1)])

    def dense(idx, w, n, stride):
        m = np.zeros((idx.shape[0], n), np.float32)
        rows = np.arange(idx.shape[0])
        np.add.at(m, (rows, idx[:, 0] // stride), w[:, 0])
        np.add.at(m, (rows, idx[:, 1] // stride), w[:, 1])
        return m

    jvol, jlight = jnp.asarray(vol_p.numpy()), jnp.asarray(light_p.numpy())
    ci, cw = planes.col_i.numpy(), planes.col_w.numpy()
    ri, rw = planes.row_i.numpy(), planes.row_w.numpy()
    for k in range(SCAN["n_planes"]):
        za_k, w_k = js.za[k], js.w_planes[k]
        for got, want in ((planes.vol[k], slab(jvol, za_k)),
                          (planes.light[k, ..., :3], slab(jlight, za_k))):
            got = got.numpy()
            np.testing.assert_array_equal(np.isfinite(got),
                                          np.isfinite(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                                       atol=1e-7)
        b_k, c_k = js.o_b + w_k * (ju - js.o_b), js.o_c + w_k * (jv - js.o_c)
        for got, want in (
                (dense(ci[k, :, :2], cw[k, :, :2], nb, 1), jsw._hat_matrix(
                    b_k, nb)),
                (dense(ci[k, :, 2:], cw[k, :, 2:], nb2, 1),
                 jsw._hat_matrix(b_k, nb2)),
                (dense(ri[k, :, :2], rw[k, :, :2], nc, nb),
                 jsw._hat_matrix(c_k, nc)),
                (dense(ri[k, :, 2:], rw[k, :, 2:], nc2, nb2),
                 jsw._hat_matrix(c_k, nc2))):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
        np.testing.assert_array_equal(planes.col_m[k].numpy(), np.asarray(
            ((b_k >= 0.0) & (b_k <= 1.0)).astype(jnp.float32)))
        np.testing.assert_array_equal(planes.row_m[k].numpy(), np.asarray(
            ((c_k >= 0.0) & (c_k <= 1.0)).astype(jnp.float32)
            * js.valid[k].astype(jnp.float32)))
    assert not bool(planes.light[..., 3].any())
    np.testing.assert_array_equal(planes.counts[:, 0].numpy(),
                                  c.nonfinite.numpy())
    np.testing.assert_array_equal(planes.counts[:, 1:].numpy(),
                                  c.lnonfinite.numpy())
    assert int(planes.counts.sum()) > 0


def test_prepare_planes_on_cpu_is_the_plain_version_and_launches_nothing():
    """The pre-pass's plain version over a part of the planes is that part
    of the whole; the forward, the pre-pass kernel's one launcher, refuses
    CPU tensors and launches nothing."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs()
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    before = telemetry.launches("sweep_planes")
    part = ss._prepare_planes_torch(vol_p, light_p, c, u, v, 5, 12)
    whole = ss._prepare_planes_torch(vol_p, light_p, c, u, v, 0, 32)
    for got, want in zip(part, whole):
        assert torch.equal(got, want[5:12])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss._forward(vol_p, light_p, tf.positions, tf.colors, c, u, v, 0.05)
    assert telemetry.launches("sweep_planes") == before


def test_the_scratch_holds_each_field_where_the_kernels_are_pointed():
    """One allocation holds a chunk's prepared planes: the pointers set in
    the kernels' arguments are the views' own, each field 256 bytes from
    the buffer's start (a card's allocation is 512-byte aligned), with the
    shapes and types of the plain version's planes and
    ``plane_bytes`` a plane."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs()
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    args = ss._Args(nc=16, nb=16, nc2=8, nb2=8, n_u=40, n_v=36)
    buf, fields = ss._scratch(args, 7, "cpu")
    planes = ss._views(buf, fields)
    want = ss._prepare_planes_torch(vol_p, light_p, c, u, v, 3, 10)
    for name, arg, got, w in zip(ss.Planes._fields, ss._PLANE_ARGS, planes,
                                 want):
        assert (got.shape, got.dtype) == (w.shape, w.dtype), name
        assert getattr(args, arg) == got.data_ptr(), name
        assert (got.data_ptr() - buf.data_ptr()) % 256 == 0, name
    assert sum(t.numel() * 4 for t in planes) == 7 * ss.plane_bytes(
        16, 16, 8, 8, 40, 36) <= buf.numel()


@pytest.mark.parametrize("n_planes,per_plane,budget,want", [
    (128, 188_448, ss.PLANE_BUDGET, [(0, 128)]),
    (7, 10, 25, [(0, 2), (2, 4), (4, 6), (6, 7)]),
    (6, 10, 30, [(0, 3), (3, 6)]),
    (1, 10 ** 9, 2 ** 20, [(0, 1)]),
    (3, 10 ** 9, 2 ** 20, [(0, 1), (1, 2), (2, 3)]),
    (0, 10, 100, []),
])
def test_chunk_plan_covers_every_plane_once_in_order(n_planes, per_plane,
                                                     budget, want):
    plan = ss.chunk_plan(n_planes, per_plane, budget)
    assert plan == want
    assert [k for lo, hi in plan for k in range(lo, hi)] == list(
        range(n_planes))
    assert all((hi - lo) * per_plane <= budget or hi - lo == 1
               for lo, hi in plan)


def test_the_default_frames_planes_fit_one_chunk_in_the_l2():
    """The default frame (128 planes, a 128^3 volume, a 65^3 light volume,
    768^2 rays) takes one chunk of 24.1 MB, under the card's 50 MB L2."""
    per = ss.plane_bytes(128, 128, 65, 65, 768, 768)
    assert ss.chunk_plan(128, per, ss.PLANE_BUDGET) == [(0, 128)]
    assert 128 * per == 24_121_344 < 50 * 10 ** 6


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CARD_KW = {"default": {}, "eye inside": dict(eye=(0.5, 0.55, 0.3),
                                             center=(0.5, 0.5, 0.9)),
           "strided columns": dict(columns=slice(3, 40, 3)),
           "on a TF point": dict(eye=(2.0, 0.4, 0.5), tie=True, pos=TIE_POS)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KW))
def test_forward_kernel_matches_plain_on_the_card(card, case):
    vol_p, light_p, tf, sched, u, v = _scan_inputs(device=card,
                                                   **CARD_KW[case])
    before = telemetry.launches("sweep_scan_forward")
    got = tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05)
    torch.cuda.synchronize()
    assert telemetry.launches("sweep_scan_forward") == before + 1
    want = tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05,
                            method="torch")
    assert telemetry.launches("sweep_scan_forward") == before + 1
    _close(got, want, CARD_RTOL, CARD_ATOL_REL, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KW))
def test_forward_kernel_gives_the_plain_loops_nan_on_the_card(card, case):
    """+inf texels in the light volume and the volume: NaN where the plain
    loop has NaN, inf where it has inf, the rest within tolerance."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(device=card,
                                                   **CARD_KW[case])
    vol_p, light_p = _with_inf(vol_p, 12, 2), _with_inf(light_p, 6, 3)
    got = tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05)
    want = tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05,
                            method="torch")
    assert bool(torch.isnan(want).any())
    finite = torch.isfinite(want)
    torch.testing.assert_close(
        got, want, rtol=CARD_RTOL, equal_nan=True,
        atol=CARD_ATOL_REL * float(want[finite].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KW))
def test_backward_kernel_matches_plain_on_the_card(card, case):
    vol_p, light_p, tf, sched, u, v = _scan_inputs(device=card,
                                                   **CARD_KW[case])
    leaves = _leaves(vol_p, light_p, tf)
    tf_g = ttypes.TransferFunction(positions=leaves[2], colors=leaves[3],
                                   lut=None)
    out = tsw._scan_planes(leaves[0], leaves[1], tf_g, sched, u, v, 0.05)
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.5, out.shape).astype(np.float32)).to(card)
    before = _grad_launches()
    got = torch.autograd.grad((out * w).sum(), leaves)
    torch.cuda.synchronize()
    assert _grad_launches(before) == (1, 1, 1)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    want = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05,
                                       out.detach(), w)
    for name, g, wg in zip(("volume", "light volume", "tf positions",
                            "tf colours"), got, want):
        _close(g, wg, CARD_GRAD_RTOL, CARD_GRAD_ATOL_REL, f"{case}: {name}")


def _grad_launches(before=(0, 0, 0)) -> tuple:
    """The pre-pass, gradient-march and fold launches since ``before``."""
    now = tuple(telemetry.launches(name) for name in (
        "sweep_planes", "sweep_scan_backward", "sweep_fold"))
    return tuple(n - b for n, b in zip(now, before))


MANY_POINTS = (17, 64, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("points", MANY_POINTS)
def test_forward_kernel_matches_plain_at_many_tf_points_on_the_card(card,
                                                                    points):
    vol_p, light_p, tf, sched, u, v = _scan_inputs(
        device=card, **dict(zip(("pos", "cols"), _many_points(points))))
    got = tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05)
    want = tsw._scan_planes(vol_p, light_p, tf, sched, u, v, 0.05,
                            method="torch")
    _close(got, want, CARD_RTOL, CARD_ATOL_REL, f"{points} points")


@pytest.mark.cuda
@pytest.mark.parametrize("points", MANY_POINTS)
def test_backward_kernel_matches_plain_at_many_tf_points_on_the_card(
        card, points):
    """At 256 points the first design's table (5 P floats a thread) did not
    fit the card's shared memory and the launch was refused."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(
        device=card, **dict(zip(("pos", "cols"), _many_points(points))))
    leaves = _leaves(vol_p, light_p, tf)
    tf_g = ttypes.TransferFunction(positions=leaves[2], colors=leaves[3],
                                   lut=None)
    out = tsw._scan_planes(leaves[0], leaves[1], tf_g, sched, u, v, 0.05)
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.5, out.shape).astype(np.float32)).to(card)
    before = _grad_launches()
    got = torch.autograd.grad((out * w).sum(), leaves)
    torch.cuda.synchronize()
    assert _grad_launches(before) == (1, 1, 1)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    want = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05,
                                       out.detach(), w)
    for name, g, wg in zip(("volume", "light volume", "tf positions",
                            "tf colours"), got, want):
        _close(g, wg, CARD_GRAD_RTOL, CARD_GRAD_ATOL_REL,
               f"{points} points: {name}")


@pytest.mark.cuda
def test_backward_with_its_tf_table_in_device_memory_on_the_card(
        card, monkeypatch):
    """No shared table (as for a transfer function of over 2,457 points):
    each run of a segment adds into the gradient with global atomics."""
    monkeypatch.setattr(ss, "TF_SHARED_BYTES", 0)
    test_backward_kernel_matches_plain_at_many_tf_points_on_the_card(card,
                                                                     64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KW))
def test_forward_in_chunks_equals_one_chunk_on_the_card(card, case,
                                                       monkeypatch):
    """A plane budget of 10 planes: 4 chunks (4 pre-pass and 4 march
    launches), each ray's colour and transmittance carried through the
    output; bit for bit the one-chunk forward."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(device=card,
                                                   **CARD_KW[case])
    u = u.contiguous()
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    args = (vol_p, light_p, tf.positions, tf.colors, c, u, v, 0.05)
    one = ss.sweep_scan_forward(*args)
    before = (telemetry.launches("sweep_planes"),
              telemetry.launches("sweep_scan_forward"))
    per = ss.plane_bytes(*vol_p.shape[1:], *light_p.shape[1:3], u.shape[0],
                         v.shape[0])
    monkeypatch.setattr(ss, "PLANE_BUDGET", 10 * per)
    chunked = ss.sweep_scan_forward(*args)
    torch.cuda.synchronize()
    assert (telemetry.launches("sweep_planes") - before[0],
            telemetry.launches("sweep_scan_forward") - before[1]) == (4, 4)
    assert torch.equal(chunked, one)
    assert float(one[..., 3].max()) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KW))
def test_plane_prepass_kernel_equals_its_plain_version_on_the_card(
        card, case, monkeypatch):
    """The planes that the forward's pre-pass left in its scratch, bit for
    bit (NaN equal) its plain version's: every plane in one chunk, and the
    last of three chunks under a budget of 13 planes."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(device=card,
                                                   **CARD_KW[case])
    vol_p, light_p = _with_inf(vol_p, 12, 2), _with_inf(light_p, 6, 3)
    u = u.contiguous()
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    per = ss.plane_bytes(*vol_p.shape[1:], *light_p.shape[1:3], u.shape[0],
                         v.shape[0])
    n = c.fz.shape[0]
    assert n == 32
    for budget, chunks, last in ((ss.PLANE_BUDGET, 1, (0, n)),
                                 (13 * per, 3, (26, n))):
        monkeypatch.setattr(ss, "PLANE_BUDGET", budget)
        before = telemetry.launches("sweep_planes")
        _, scratch = ss._forward(vol_p, light_p, tf.positions, tf.colors, c,
                                 u, v, 0.05)
        torch.cuda.synchronize()
        assert telemetry.launches("sweep_planes") == before + chunks
        got, span = ss._filled(scratch)
        assert span == last
        want = ss._prepare_planes_torch(vol_p, light_p, c, u, v, *last)
        for name, g, w in zip(ss.Planes._fields, got, want):
            assert torch.equal(g.nan_to_num(), w.nan_to_num()), name
            assert torch.equal(torch.isnan(g), torch.isnan(w)), name


def _card_grad_inputs(card, case):
    """``case``'s scan on the card with its constants, the forward's image
    and a seeded cotangent of it."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(device=card,
                                                   **CARD_KW[case])
    u = u.contiguous()
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    out = ss.sweep_scan_forward(vol_p, light_p, tf.positions, tf.colors, c,
                                u, v, 0.05)
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.5, out.shape).astype(np.float32)).to(card)
    return (vol_p, light_p, tf.positions, tf.colors, c, u, v, 0.05, out, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KW))
def test_backward_in_chunks_matches_one_chunk_on_the_card(card, case,
                                                         monkeypatch):
    """A plane budget of 10 planes of the backward: 4 chunks (4 pre-pass,
    4 gradient-march and 4 fold launches), each ray's colour and
    transmittance carried through the scratch; within the backward's
    tolerance of the one-chunk backward (the transfer function's sums
    are flushed per chunk, and atomics reorder every sum)."""
    args = _card_grad_inputs(card, case)
    one = ss.sweep_scan_backward(*args)
    vol_p, light_p, _, _, _, u, v = args[:7]
    per = ss.grad_plane_bytes(*vol_p.shape[1:], *light_p.shape[1:3],
                              u.shape[0], v.shape[0])
    monkeypatch.setattr(ss, "PLANE_BUDGET", 10 * per)
    before = _grad_launches()
    chunked = ss.sweep_scan_backward(*args)
    torch.cuda.synchronize()
    assert _grad_launches(before) == (4, 4, 4)
    for name, g, wg in zip(("volume", "light volume", "tf positions",
                            "tf colours"), chunked, one):
        _close(g, wg, CARD_GRAD_RTOL, CARD_GRAD_ATOL_REL,
               f"{case}, 4 chunks: {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KW))
def test_fold_kernel_equals_its_plain_version_on_the_card(card, case):
    """The gradient planes that a one-chunk backward's gradient march left
    in its scratch, folded by ``_fold_plane_grads_torch`` on the CPU: bit
    for bit the gradients of the volume and the light volume that the fold
    kernel made of them (a gather in index_add_'s order)."""
    args = _card_grad_inputs(card, case)
    grads, scratch = ss._backward(*args)
    torch.cuda.synchronize()
    g_p_vol, g_p_light, (lo, hi) = ss._grad_planes(scratch)
    assert (lo, hi) == (0, 32)
    c = _cpu_constants(args[4])
    vol_p, light_p = args[0].cpu(), args[1].cpu()
    want = tsw._fold_plane_grads_torch(
        torch.zeros_like(vol_p), torch.zeros_like(light_p), g_p_vol.cpu(),
        g_p_light.cpu(), c, lo, hi)
    assert float(want[0].abs().max()) > 0.0
    assert float(want[1].abs().max()) > 0.0
    assert torch.equal(grads[0].cpu(), want[0])
    assert torch.equal(grads[1].cpu(), want[1])


def _cpu_constants(c):
    """The scan's constants on the CPU."""
    return c._replace(**{f: t.cpu() for f, t in c._asdict().items()
                         if isinstance(t, torch.Tensor)})

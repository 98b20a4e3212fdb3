"""The sweep's backward as the kernels run it, chunk by chunk, in its plain
versions (``ops/sweep_render.py``: ``_scan_planes_grad_chunked_torch``,
``_fold_plane_grads_torch``) and the wrapper's scratch and chunk plan
(``kernels/sweep_scan.py``), at tests/test_torch_sweep_kernel.py's scan (a
16^3 smoke cloud, an 8^3 light volume, 32 planes, 40 x 36 rays):

- the chunked plain backward (the prepared planes of each chunk, the
  kernels' taps, each ray's colour and transmittance carried from chunk to
  chunk, the cotangents scattered per row into gradient planes, the
  transfer function's sums flushed per chunk, the fold) in 1, 2 and 3
  chunks against ``_scan_planes_grad_torch`` and against ``jax.grad`` of
  the reference's ``_scan_planes``, at 4 and 17 TF points and with the eye
  inside;
- ``_scan_planes_grad_torch`` on the kernels' samples (the prepared
  planes) against the one-chunk plain backward: its transfer function's
  gradients bit for bit;
- the fold's plain version against the two ``index_add_`` calls that
  ``_scan_planes_grad_torch`` made before it, bit for bit;
- the backward's scratch (prepared planes, gradient planes, the carry)
  holds each field where the kernels' arguments point, and the default
  frame's backward plans one chunk of 41.2 MB, under the card's 50 MB L2,
  with no carry.

Tolerances: gradients to rtol 1e-4 with an absolute floor of 1e-5 of the
largest component, as tests/test_torch_sweep_kernel.py's (float32 sums in
another order). The reference is imported inside the tests that use it.
"""

import functools

import numpy as np
import pytest
import torch

from cpm_tpu_torch.kernels import sweep_scan as ss
from cpm_tpu_torch.ops import sweep_render as tsw

from test_torch_sweep_kernel import (CENTER, EYE, GRAD_ATOL_REL, GRAD_RTOL,
                                     SCAN, _close, _many_points,
                                     _scan_inputs)

INSIDE = dict(eye=(0.5, 0.55, 0.3), center=(0.5, 0.5, 0.9))
CASES = {"4 points": {}, "17 points": dict(zip(("pos", "cols"),
                                               _many_points(17))),
         "eye inside": INSIDE}
NAMES = ("volume", "light volume", "tf positions", "tf colours")


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread beside JAX's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weight(shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(6).uniform(
        0.5, 1.5, shape).astype(np.float32))


@functools.cache
def _reference_grads(case: str) -> tuple:
    """``jax.grad`` of the reference's ``_scan_planes`` on ``case``'s scan,
    for the loss sum(intermediate image x _weight)."""
    import jax
    import jax.numpy as jnp

    from cpm_tpu.core import camera as jcamera
    from cpm_tpu.core.types import TransferFunction as JTF
    from cpm_tpu.ops import sweep_render as jsw

    kw = CASES[case]
    vol_p, light_p, tf, sched, u, v = _scan_inputs(**kw)
    jcam = jcamera.Camera.create(eye=kw.get("eye", EYE),
                                 center=kw.get("center", CENTER))
    axis, sign = jsw.principal_axis(jcam)
    js = jsw._plane_schedule(jcam, axis, sign, SCAN["n_planes"],
                             SCAN["width"], SCAN["height"])
    ju, jv = jsw.base_grid(js, SCAN["inter_u"], SCAN["inter_v"])
    w = _weight((v.shape[0], u.shape[0], 4)).numpy()

    def loss(vp, lp, p, cl):
        inter = jsw._scan_planes(vp, lp, JTF.from_points(p, cl), js, ju, jv,
                                 0.05)
        return jnp.sum(inter * w)

    args = [jnp.asarray(a) for a in (vol_p.numpy(), light_p.numpy(),
                                     tf.positions.numpy(),
                                     tf.colors.numpy())]
    return tuple(np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2, 3))(*args))


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_plain_backward_matches_the_plain_one_and_jax_grad(case,
                                                                   chunks):
    """A budget of all, 16 or 11 planes' bytes: 1, 2 or 3 chunks (of 32,
    16 + 16, 11 + 11 + 10 planes)."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(**CASES[case])
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    per = ss.grad_plane_bytes(*vol_p.shape[1:], *light_p.shape[1:3],
                              u.shape[0], v.shape[0])
    budget = {1: ss.PLANE_BUDGET, 2: 16 * per, 3: 11 * per}[chunks]
    assert len(ss.chunk_plan(SCAN["n_planes"], per, budget)) == chunks
    out = tsw._scan_planes_torch(vol_p, light_p, tf, c, u, v, 0.05)
    w = _weight(out.shape)
    got = tsw._scan_planes_grad_chunked_torch(vol_p, light_p, tf, c, u, v,
                                              0.05, out, w, budget)
    plain = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05,
                                        out, w)
    for name, g, want in zip(NAMES, got, plain):
        _close(g, want, GRAD_RTOL, GRAD_ATOL_REL,
               f"{case}, {chunks} chunk(s), against the plain one: {name}")
    for name, g, want in zip(NAMES, got, _reference_grads(case)):
        _close(g, want, GRAD_RTOL, GRAD_ATOL_REL,
               f"{case}, {chunks} chunk(s), against jax.grad: {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_the_plain_backward_on_the_kernels_samples_matches_the_chunked_one(
        case):
    """``_scan_planes_grad_torch`` sampling each plane by the kernels' taps
    (the prepared planes) and scattering through the hat matrices: the
    transfer function's gradients bit for bit the one-chunk plain
    backward's (the same samples and sums in the same order), the
    volumes' within the tolerance (another scatter); and nearer to it
    than the products' samples leave the plain loop, or as near."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(**CASES[case])
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    out = tsw._scan_planes_torch(vol_p, light_p, tf, c, u, v, 0.05)
    w = _weight(out.shape)
    planes = ss._prepare_planes_torch(vol_p, light_p, c, u, v, 0,
                                      c.fz.shape[0])
    got = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05, out,
                                      w, planes=planes)
    chunked = tsw._scan_planes_grad_chunked_torch(vol_p, light_p, tf, c, u,
                                                  v, 0.05, out, w)
    products = tsw._scan_planes_grad_torch(vol_p, light_p, tf, c, u, v, 0.05,
                                           out, w)
    assert torch.equal(got[2], chunked[2])
    assert torch.equal(got[3], chunked[3])
    for name, g, want, far in zip(NAMES[:2], got, chunked, products):
        _close(g, want, GRAD_RTOL, GRAD_ATOL_REL,
               f"{case}, on the kernels' samples: {name}")
        assert float((g - want).abs().max()) <= float(
            (far - want).abs().max())


@pytest.mark.parametrize("eye", [EYE, (2.0, 0.4, 0.5), (0.5, 0.55, 0.3)])
def test_the_folds_plain_version_equals_the_index_add_it_replaced(eye):
    """Seeded gradient planes of every plane of a scan (neighbouring planes
    share slabs), folded into zeros: bit for bit what
    ``_scan_planes_grad_torch`` computed inline before the fold was lifted
    out."""
    vol_p, light_p, tf, sched, u, v = _scan_inputs(eye=eye)
    c = tsw.scan_constants(vol_p, light_p, sched, u, v)
    n = c.fz.shape[0]
    rs = np.random.default_rng(8)
    g_p_vol = torch.from_numpy(rs.standard_normal(
        (n, *vol_p.shape[1:])).astype(np.float32))
    g_p_light = torch.from_numpy(rs.standard_normal(
        (n, *light_p.shape[1:])).astype(np.float32))
    assert int(torch.unique(c.k0).numel()) < n  # planes share slabs

    g_s0, g_s1 = torch.zeros_like(g_p_vol), torch.zeros_like(g_p_vol)
    g_l0, g_l1 = torch.zeros_like(g_p_light), torch.zeros_like(g_p_light)
    for k in range(n):
        g_s0[k] = (1.0 - c.fz[k]) * g_p_vol[k]
        g_s1[k] = c.fz[k] * g_p_vol[k]
        g_l0[k] = (1.0 - c.lfz[k]) * g_p_light[k]
        g_l1[k] = c.lfz[k] * g_p_light[k]
    want_vol = torch.zeros_like(vol_p).index_add_(0, c.k0, g_s0).index_add_(
        0, c.k1, g_s1)
    want_light = torch.zeros_like(light_p).index_add_(0, c.lk0, g_l0) \
        .index_add_(0, c.lk1, g_l1)

    got = tsw._fold_plane_grads_torch(torch.zeros_like(vol_p),
                                      torch.zeros_like(light_p), g_p_vol,
                                      g_p_light, c, 0, n)
    assert torch.equal(got[0], want_vol)
    assert torch.equal(got[1], want_light)
    # The kernels' padded light planes fold the same; the pad is ignored.
    padded = torch.cat([g_p_light, torch.full_like(g_p_light[..., :1], 7.0)],
                       -1)
    got = tsw._fold_plane_grads_torch(torch.zeros_like(vol_p),
                                      torch.zeros_like(light_p), g_p_vol,
                                      padded, c, 0, n)
    assert torch.equal(got[1], want_light)


def test_the_backwards_scratch_holds_each_field_where_its_pointer_is_set():
    """One allocation holds a chunk's prepared planes, its gradient planes
    and the rays' carry: the pointers set in the kernels' arguments are the
    views' own, each field 256 bytes aligned from the buffer's start (the
    light's gradient plane takes float4 atomics, the carry float4 loads),
    with the shapes of the plain versions' planes and
    ``grad_plane_bytes`` a plane."""
    args = ss._Args(nc=16, nb=16, nc2=8, nb2=8, n_u=40, n_v=36)
    buf, fields = ss._scratch(args, 7, "cpu", grad=True, carry=True)
    views = ss._views(buf, fields)
    names = (*ss._PLANE_ARGS, *ss._GRAD_ARGS, "carry")
    assert len(views) == len(names) == 12
    for name, view in zip(names, views):
        assert getattr(args, name) == view.data_ptr(), name
        assert (view.data_ptr() - buf.data_ptr()) % 256 == 0, name
    assert tuple(views[9].shape) == (7, 16, 16)
    assert tuple(views[10].shape) == (7, 8, 8, 4)
    assert tuple(views[11].shape) == (36, 40, 4)
    assert sum(t.numel() * 4 for t in views[:11]) == 7 * ss.grad_plane_bytes(
        16, 16, 8, 8, 40, 36)
    assert sum(t.numel() * 4 for t in views) <= buf.numel()
    # The forward's scratch holds the prepared planes alone.
    args = ss._Args(nc=16, nb=16, nc2=8, nb2=8, n_u=40, n_v=36)
    buf, fields = ss._scratch(args, 7, "cpu")
    assert len(ss._views(buf, fields)) == 9
    assert args.g_p_vol is args.g_p_light is args.carry is None


def test_the_default_frames_backward_plans_one_chunk_in_the_l2():
    """The default frame's backward (128 planes of a 128^3 volume and a
    65^3 light volume, 768^2 rays): one chunk of 41.2 MB (24.1 MB of
    prepared planes, 17.0 MB of gradient planes), under the card's 50 MB
    L2, and no carry (the (V, U, 4) carry is 9.4 MB)."""
    per = ss.grad_plane_bytes(128, 128, 65, 65, 768, 768)
    plan = ss.chunk_plan(128, per, ss.PLANE_BUDGET)
    assert plan == [(0, 128)]
    assert 128 * per == 41_162_752 < 50 * 10 ** 6
    assert 128 * (per - ss.plane_bytes(128, 128, 65, 65, 768, 768)) == \
        17_041_408
    args = ss._Args(nc=128, nb=128, nc2=65, nb2=65, n_u=768, n_v=768)
    buf, fields = ss._scratch(args, 128, "cpu", grad=True,
                              carry=len(plan) > 1)
    assert len(fields) == 11 and args.carry is None
    assert buf.numel() < 128 * per + 11 * 256

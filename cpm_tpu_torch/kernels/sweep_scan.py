"""The sweep's plane scan as two Hopper kernels (``csrc/sweep_scan.cu``):
its wrappers, which launch the forward once per sweep and the backward
once per gradient through it, on CUDA tensors.

They replace ``cpm_tpu/ops/sweep_render.py:_scan_planes`` (:203-271), the
``lax.scan`` over planes with its hat-matrix products, which the port's
plain version (``ops/sweep_render._scan_planes_torch``) runs as one torch
step per plane, and the reference's ``jax.grad`` of it, whose plain
version here is ``ops/sweep_render._scan_planes_grad_torch``. The source
is compiled with ``nvcc`` for ``sm_90a`` at first use by the port's one
build routine (``kernels/_build.py``), with ``--fmad=false`` so that every
product and sum rounds on its own, as torch's one operator per launch
does, and loaded with ctypes. Nothing is built or imported for CUDA when
this module is imported.

:func:`sweep_scan` takes the permuted volumes, the transfer function's
points, the scan's constants (``ops/sweep_render.scan_constants``) and the
base-grid rays, checks them and launches the forward on the current
stream; where a gradient is asked for it goes through :class:`SweepScan`,
whose backward launches the backward kernel. They raise on tensors of
another device, type, shape or layout, on more transfer-function points
than the kernels' table holds, on a constant that requires grad and on a
launch that fails. ``sweep_scan_forward.launches`` and
``sweep_scan_backward.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from cpm_tpu_torch.kernels import _build

Tensor = torch.Tensor

SOURCE = _build.CSRC / "sweep_scan.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "--fmad=false")
MAX_TF_POINTS = 16  # kMaxTf: the kernels' shared table of points

# Float operations that one sample needs, counted from the source, for a
# bound: the plane's positions 6, four hat rows 56, the masks 6, the
# volume's slab lerps and taps 19, the light's 64, the composite with its
# expf (counted as 10) 29; of the transfer function, one compare per
# segment and 18 for the one segment that survives the where chain (its
# width, parameter, clip and four-channel lerp: the kernel computes every
# segment's, in the plain loop's order, but the others are discarded). The
# backward marches again and adds 187: the recurrence and the cotangents
# 47, the transfer function's adjoint 36, the scatter weights 72 and one
# add per gradient contribution 32.
OPS_PER_SAMPLE = 180
OPS_PER_TF_COMPARE = 1
OPS_PER_TF_LERP = 18
GRAD_OPS_PER_SAMPLE = 187


def ops_per_sample(tf_points: int, backward: bool = False) -> int:
    """Float operations that one sample (one ray at one plane) needs."""
    ops = OPS_PER_SAMPLE
    if tf_points > 1:
        ops += OPS_PER_TF_COMPARE * (tf_points - 1) + OPS_PER_TF_LERP
    return ops + GRAD_OPS_PER_SAMPLE if backward else ops


class _Args(ctypes.Structure):
    """``struct ScanArgs`` of the source, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "vol", "light", "tf_pos", "tf_col", "k0", "k1", "fz", "lk0", "lk1",
        "lfz", "valid", "w_planes", "u", "v", "dl", "o_b", "o_c",
        "nonfinite", "lnonfinite", "out", "grad_out", "g_vol", "g_light",
        "g_pos", "g_col")] + [
        (name, ctypes.c_int) for name in (
            "na", "nc", "nb", "na2", "nc2", "nb2", "tf_n", "n_planes", "n_u",
            "n_v")] + [("sbi", ctypes.c_float), ("ambient", ctypes.c_float)]


def build() -> tuple[Path, str]:
    """Compile the kernels (once per source version) and return the shared
    library's path and the compiler's log."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    for fn in (lib.cpm_sweep_scan, lib.cpm_sweep_scan_grad):
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: Tensor, dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _args(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor, tf_col: Tensor,
          c, u: Tensor, v: Tensor, ambient: float, out: Tensor,
          grad_out: Tensor | None = None, grads=(None,) * 4) -> _Args:
    """Check the inputs and pack the kernels' arguments."""
    dev = vol_p.device
    if dev.type != "cuda":
        raise ValueError(f"the volume is on {dev}; the sweep kernels take "
                         "CUDA tensors")
    na, nc, nb = vol_p.shape if vol_p.dim() == 3 else (-1, -1, -1)
    na2, nc2, nb2 = light_p.shape[:3] if light_p.dim() == 4 else (-1,) * 3
    s, n_u, n_v, p = c.fz.shape[0], u.shape[0], v.shape[0], tf_pos.shape[0]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for name, t, dtype, shape in (
            ("vol_p", vol_p, f32, (na, nc, nb)),
            ("light_p", light_p, f32, (na2, nc2, nb2, 3)),
            ("tf positions", tf_pos, f32, (p,)),
            ("tf colours", tf_col, f32, (p, 4)),
            ("k0", c.k0, i64, (s,)), ("k1", c.k1, i64, (s,)),
            ("fz", c.fz, f32, (s,)), ("lk0", c.lk0, i64, (s,)),
            ("lk1", c.lk1, i64, (s,)), ("lfz", c.lfz, f32, (s,)),
            ("valid", c.valid, f32, (s,)),
            ("w_planes", c.w_planes, f32, (s,)),
            ("u", u, f32, (n_u,)), ("v", v, f32, (n_v,)),
            ("dl", c.dl, f32, (n_v, n_u)), ("o_b", c.o_b, f32, ()),
            ("o_c", c.o_c, f32, ()), ("nonfinite", c.nonfinite, i32, (s,)),
            ("lnonfinite", c.lnonfinite, i32, (s, 3)),
            ("out", out, f32, (n_v, n_u, 4))):
        _check(name, t, dtype, shape, dev)
    if grad_out is not None:
        _check("grad_out", grad_out, f32, (n_v, n_u, 4), dev)
    if not 1 <= p <= MAX_TF_POINTS:
        raise ValueError(f"the sweep kernels take 1 to {MAX_TF_POINTS} "
                         f"transfer-function points, got {p}")
    if min(na, nc, nb, na2, nc2, nb2) < 1:
        raise ValueError("an empty volume or light volume")
    if max(vol_p.numel(), light_p.numel(), out.numel()) >= 2 ** 31:
        raise ValueError("a volume or image too large for 32-bit offsets")
    return _Args(
        *(_ptr(t) for t in (vol_p, light_p, tf_pos, tf_col, c.k0, c.k1, c.fz,
                            c.lk0, c.lk1, c.lfz, c.valid, c.w_planes, u, v,
                            c.dl, c.o_b, c.o_c, c.nonfinite, c.lnonfinite,
                            out, grad_out, *grads)),
        na, nc, nb, na2, nc2, nb2, p, s, n_u, n_v, float(c.sbi),
        float(ambient))


def _launch(fn, args: _Args, dev, what: str) -> None:
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep scan {what} kernel: CUDA error {err}")


def sweep_scan_forward(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor,
                       tf_col: Tensor, c, u: Tensor, v: Tensor,
                       ambient: float) -> Tensor:
    """The (V, U, 4) intermediate image in one launch, one thread per ray.

    ``vol_p`` (na, nc, nb) and ``light_p`` (na2, nc2, nb2, 3) are the
    volumes permuted to the marching axis, float32, contiguous; ``tf_pos``
    (P,) and ``tf_col`` (P, 4) the transfer function's points; ``c`` the
    scan's :class:`~cpm_tpu_torch.ops.sweep_render.ScanConstants`; ``u``
    (U,) and ``v`` (V,) the base-grid columns and rows, all on one CUDA
    device. A plane whose slab holds a non-finite texel gives NaN where
    the plain loop's matrix products do (``c.nonfinite``,
    ``c.lnonfinite``). Nothing is read back to the host."""
    out = torch.empty((v.shape[0], u.shape[0], 4), dtype=torch.float32,
                      device=vol_p.device)
    args = _args(vol_p, light_p, tf_pos, tf_col, c, u, v, ambient, out)
    if out.numel() == 0:
        return out
    _launch(_library().cpm_sweep_scan, args, vol_p.device, "forward")
    sweep_scan_forward.launches += 1
    return out


def sweep_scan_backward(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor,
                        tf_col: Tensor, c, u: Tensor, v: Tensor,
                        ambient: float, out: Tensor, grad_out: Tensor,
                        needs=(True,) * 4) -> tuple:
    """The gradients (vol_p, light_p, tf positions, tf colours) for the
    cotangent ``grad_out`` of the forward's ``out``, in one launch; an
    entry of ``needs`` that is False gives None and is not computed. The
    volume's and light volume's gradients are sums of atomic adds, whose
    order changes from run to run."""
    dev = vol_p.device
    grads = tuple(torch.zeros_like(t) if need else None for t, need in zip(
        (vol_p, light_p, tf_pos, tf_col), needs))
    args = _args(vol_p, light_p, tf_pos, tf_col, c, u, v, ambient, out,
                 grad_out, grads)
    if out.numel() == 0 or not any(needs):
        return grads
    _launch(_library().cpm_sweep_scan_grad, args, dev, "backward")
    sweep_scan_backward.launches += 1
    return grads


sweep_scan_forward.launches = 0
sweep_scan_backward.launches = 0


class SweepScan(torch.autograd.Function):
    """The forward kernel, differentiable in the volume, the light volume
    and the transfer function's positions and colours; the backward is the
    backward kernel. The constants and the rays are not differentiated."""

    @staticmethod
    def forward(ctx, vol_p, light_p, tf_pos, tf_col, c, u, v, ambient):
        out = sweep_scan_forward(vol_p, light_p, tf_pos, tf_col, c, u, v,
                                 ambient)
        ctx.save_for_backward(vol_p, light_p, tf_pos, tf_col, u, v, out)
        ctx.c, ctx.ambient = c, ambient
        return out

    @staticmethod
    def backward(ctx, grad_out):
        vol_p, light_p, tf_pos, tf_col, u, v, out = ctx.saved_tensors
        grads = sweep_scan_backward(
            vol_p, light_p, tf_pos, tf_col, ctx.c, u, v, ctx.ambient, out,
            grad_out.contiguous(), ctx.needs_input_grad[:4])
        return (*grads, None, None, None, None)


def sweep_scan(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor,
               tf_col: Tensor, c, u: Tensor, v: Tensor,
               ambient: float) -> Tensor:
    """The plane scan on the card: the forward kernel, through
    :class:`SweepScan` where autograd records a gradient of the volume,
    the light volume or the transfer function. ``u`` and ``v`` are made
    contiguous (a rank's columns may be a strided slice); a constant or a
    ray coordinate that requires grad raises."""
    if vol_p.device.type != "cuda":
        raise ValueError(f"the volume is on {vol_p.device}; the sweep "
                         "kernels take CUDA tensors")
    fixed = {"u": u, "v": v, **{f: t for f, t in c._asdict().items()
                                if isinstance(t, Tensor)}}
    for name, t in fixed.items():
        if t.requires_grad:
            raise ValueError(f"the sweep kernels do not differentiate {name}")
    u, v = u.contiguous(), v.contiguous()
    inputs = (vol_p, light_p, tf_pos.contiguous(), tf_col.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return SweepScan.apply(*inputs, c, u, v, ambient)
    return sweep_scan_forward(*inputs, c, u, v, ambient)

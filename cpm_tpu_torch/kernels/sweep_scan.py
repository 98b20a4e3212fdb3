"""The sweep's plane scan as Hopper kernels (``csrc/sweep_scan.cu``): its
wrappers, which launch the forward (a plane pre-pass and a march, one of
each a chunk of planes) once per sweep and the backward once per gradient
through it, on CUDA tensors.

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

The forward is two kernels. The plane pre-pass (launched by
:func:`sweep_planes`; its plain version is :func:`_prepare_planes_torch`)
writes, for a chunk
of planes, each plane's lerped slab of the volume (S, nc, nb), of the
light volume (S, nc2, nb2, 4) with a zero pad, the taps and weights of
the hat rows of every column and row on both grids, the masks and the
planes' non-finite counts (:class:`Planes`). The march then reads them,
one thread a ray, and carries each ray's colour and transmittance from
chunk to chunk in its output. Chunks hold as many planes as fit under
``PLANE_BUDGET`` bytes (:func:`chunk_plan`), so a large volume with many
planes needs no scratch of its size; the wrapper allocates the scratch
and the kernels allocate nothing. The transfer function may have any
number of points: the kernels read them from device memory, and the
backward sums its gradient in a shared table where ``5 P`` floats fit
under ``TF_SHARED_BYTES``, in the gradient itself otherwise.

The backward is three kernels a chunk (under ``PLANE_BUDGET`` bytes of
:func:`grad_plane_bytes` a plane): the same pre-pass, which also zeroes
the chunk's gradient planes (the volume's (S, nc, nb), the light's (S,
nc2, nb2, 4)); the gradient march (one thread a ray, the same sample
function as the march), which adds each sample's cotangent through its
taps into the gradient planes and carries each ray's colour and
transmittance from chunk to chunk in a (V, U, 4) scratch where there is
more than one chunk; and the fold (:func:`sweep_fold`), which adds the
gradient planes through the slab lerps into the volumes' gradients. Its
plain versions are ``ops/sweep_render._scan_planes_grad_chunked_torch``
and ``ops/sweep_render._fold_plane_grads_torch``.

:func:`sweep_scan` takes the permuted volumes, the transfer function's
points, the scan's constants (``ops/sweep_render.scan_constants``) and the
base-grid rays, checks them and launches the forward on the current
stream; where a gradient is asked for it goes through :class:`SweepScan`,
whose backward launches the backward kernels. They raise on tensors of
another device, type, shape or layout, on a transfer function without a
point, on a constant that requires grad and on a launch that fails.
The recorder (``core/telemetry.py``) counts the launches under the
wrappers' names: ``sweep_planes`` (forward and backward),
``sweep_scan_forward`` (the march), ``sweep_scan_backward`` (the gradient
march) and ``sweep_fold``. :func:`_forward`
and :func:`_backward` are the forward and the backward with the scratch
they filled, which :func:`_filled` and :func:`_grad_planes` read for
checks.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.kernels import _build

Tensor = torch.Tensor

SOURCE = _build.CSRC / "sweep_scan.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "--fmad=false")
# Bytes of prepared planes a chunk: the forward's scratch. At the default
# frame (128 planes of a 128^3 volume and a 65^3 light volume, 768^2 rays)
# one chunk takes 24.1 MB; a 512^3 volume with 1,024 planes takes three.
PLANE_BUDGET = 512 * 2 ** 20
# The backward's transfer-function gradient table in shared memory, 5 P
# floats, up to the card's default of 48 KiB a block (P <= 2,457); above,
# each run of a segment adds into the gradient with global atomics.
TF_SHARED_BYTES = 48 * 1024

# Float operations that one sample needs, counted from the source, for a
# bound: the plane's positions 6, four hat rows 56, the masks 6, the
# volume's slab lerps and taps 19, the light's 64, the composite with its
# expf (counted as 10) 29; of the transfer function, one compare per
# segment and 18 for the one segment that survives the where chain (its
# width, parameter, clip and four-channel lerp). The pre-pass computes the
# slab lerps and hat rows once a plane, row or column, but the bound keeps
# this count, as the first design's was, so that the shares compare. The
# backward marches again and adds 187: the recurrence and the cotangents
# 47, the transfer function's adjoint 36, the scatter weights 72 and one
# add per gradient contribution 32 (the scatter's through the taps and
# the slab lerps, whichever kernel does them).
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


class Planes(NamedTuple):
    """One chunk's prepared planes (S planes, U columns, V rows): what the
    pre-pass writes and the march reads. ``col_i`` holds the volume's two
    column taps and the light's (S, U, 4), ``row_i`` the rows' likewise
    times their row lengths (nb, nb2); a second tap equal to the first is
    the clamped edge, whose weight is 0. ``row_m`` is the row's in-box
    mask times the plane's validity, ``counts`` the non-finite texels of
    the plane's lerped slabs (volume; light r, g, b)."""

    vol: Tensor  # (S, nc, nb)
    light: Tensor  # (S, nc2, nb2, 4), channel 3 zero
    col_i: Tensor  # (S, U, 4) int32
    col_w: Tensor  # (S, U, 4)
    col_m: Tensor  # (S, U)
    row_i: Tensor  # (S, V, 4) int32
    row_w: Tensor  # (S, V, 4)
    row_m: Tensor  # (S, V)
    counts: Tensor  # (S, 4) int32


def plane_bytes(nc: int, nb: int, nc2: int, nb2: int, n_u: int,
                n_v: int) -> int:
    """Bytes of one prepared plane (:class:`Planes`)."""
    return 4 * nc * nb + 16 * nc2 * nb2 + 36 * (n_u + n_v) + 16


def grad_plane_bytes(nc: int, nb: int, nc2: int, nb2: int, n_u: int,
                     n_v: int) -> int:
    """Bytes of one plane of the backward: a prepared plane and its two
    gradient planes, the volume's (nc, nb) and the light's (nc2, nb2, 4)."""
    return plane_bytes(nc, nb, nc2, nb2, n_u, n_v) + 4 * nc * nb + \
        16 * nc2 * nb2


def chunk_plan(n_planes: int, per_plane: int,
               budget: int) -> list[tuple[int, int]]:
    """The chunks of a forward or a backward: [lo, hi) ranges of planes, in
    order, that cover every plane once, each with as many planes as fit in
    ``budget`` bytes of ``per_plane`` each (at least one)."""
    step = max(1, budget // max(1, per_plane))
    return [(lo, min(lo + step, n_planes))
            for lo in range(0, n_planes, step)]


def _plane_fields(n: int, nc: int, nb: int, nc2: int, nb2: int, n_u: int,
                  n_v: int) -> tuple:
    """(dtype, shape) of each :class:`Planes` field for ``n`` planes."""
    f32, i32 = torch.float32, torch.int32
    return ((f32, (n, nc, nb)), (f32, (n, nc2, nb2, 4)), (i32, (n, n_u, 4)),
            (f32, (n, n_u, 4)), (f32, (n, n_u)), (i32, (n, n_v, 4)),
            (f32, (n, n_v, 4)), (f32, (n, n_v)), (i32, (n, 4)))


def _grad_fields(n: int, nc: int, nb: int, nc2: int, nb2: int) -> tuple:
    """(dtype, shape) of the backward's gradient planes for ``n`` planes:
    the volume's and the light's, with the prepared planes' layout."""
    return ((torch.float32, (n, nc, nb)), (torch.float32, (n, nc2, nb2, 4)))


def _field_bytes(shape: tuple) -> int:
    """A field's room in the scratch: 4-byte elements, 256-byte aligned."""
    return -(-4 * math.prod(shape) // 256) * 256


def _hat_taps(x: Tensor, n: int):
    """The two taps of ``ops/sweep_render._hat_matrix``'s rows and their
    weights, as ``hat()`` in the source computes them: (i0, i1, w0, w1)."""
    v = torch.clamp(x * n - 0.5, 0.0, n - 1.0)
    f0 = torch.floor(v)
    i0 = f0.to(torch.int32)
    w0 = torch.clamp(1.0 - torch.abs(v - f0), min=0.0)
    last = i0 + 1 > n - 1
    i1 = torch.where(last, i0, i0 + 1)
    w1 = torch.where(last, 0.0, torch.clamp(
        1.0 - torch.abs(v - (f0 + 1.0)), min=0.0))
    return i0, i1, w0, w1


def _in_box(x: Tensor) -> Tensor:
    return ((x >= 0.0) & (x <= 1.0)).to(torch.float32)


def _prepare_planes_torch(vol_p: Tensor, light_p: Tensor, c, u: Tensor,
                          v: Tensor, lo: int, hi: int) -> Planes:
    """The pre-pass's plain version: planes ``lo`` to ``hi`` of the scan
    (``c`` its constants, ``u``, ``v`` its rays) by the kernel's
    operations."""
    nc, nb = vol_p.shape[1:]
    nc2, nb2 = light_p.shape[1:3]
    ks = slice(lo, hi)
    fz = c.fz[ks][:, None, None]
    lfz = c.lfz[ks][:, None, None, None]
    vol = (1.0 - fz) * vol_p[c.k0[ks]] + fz * vol_p[c.k1[ks]]
    light = (1.0 - lfz) * light_p[c.lk0[ks]] + lfz * light_p[c.lk1[ks]]
    light = torch.cat([light, torch.zeros_like(light[..., :1])], -1)
    w = c.w_planes[ks][:, None]
    bk = c.o_b + w * (u[None, :] - c.o_b)
    ck = c.o_c + w * (v[None, :] - c.o_c)
    hb, hb2 = _hat_taps(bk, nb), _hat_taps(bk, nb2)
    hc, hc2 = _hat_taps(ck, nc), _hat_taps(ck, nc2)
    col_i = torch.stack([hb[0], hb[1], hb2[0], hb2[1]], -1)
    row_i = torch.stack([hc[0] * nb, hc[1] * nb, hc2[0] * nb2,
                         hc2[1] * nb2], -1)
    return Planes(
        vol=vol, light=light, col_i=col_i,
        col_w=torch.stack([hb[2], hb[3], hb2[2], hb2[3]], -1),
        col_m=_in_box(bk), row_i=row_i,
        row_w=torch.stack([hc[2], hc[3], hc2[2], hc2[3]], -1),
        row_m=_in_box(ck) * c.valid[ks][:, None],
        counts=torch.cat([c.nonfinite[ks][:, None], c.lnonfinite[ks]], 1))


# The pointer fields of ``struct ScanArgs`` that a chunk's Planes fill,
# and those of the backward's scratch after them: the gradient planes and
# the rays' carry from chunk to chunk.
_PLANE_ARGS = ("p_vol", "p_light", "col_i", "col_w", "col_m", "row_i",
               "row_w", "row_m", "counts")
_GRAD_ARGS = ("g_p_vol", "g_p_light")


class _Args(ctypes.Structure):
    """``struct ScanArgs`` of the source, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "vol", "light", "tf_pos", "tf_col", "k0", "k1", "fz", "lk0", "lk1",
        "lfz", "valid", "w_planes", "u", "v", "dl", "o_b", "o_c",
        "nonfinite", "lnonfinite", "out", "grad_out", "g_vol", "g_light",
        "g_pos", "g_col", *_PLANE_ARGS, *_GRAD_ARGS, "carry")] + [
        (name, ctypes.c_int) for name in (
            "na", "nc", "nb", "na2", "nc2", "nb2", "tf_n", "n_planes", "n_u",
            "n_v", "k_lo", "k_hi", "first", "last", "tf_shared")] + [
        ("sbi", ctypes.c_float), ("ambient", ctypes.c_float)]


def build() -> tuple[Path, str]:
    """Compile the kernels (once per source version) and return the shared
    library's path and the compiler's log."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    for fn in (lib.cpm_sweep_planes, lib.cpm_sweep_scan,
               lib.cpm_sweep_scan_grad, lib.cpm_sweep_fold):
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


def _args(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor | None,
          tf_col: Tensor | None, c, u: Tensor, v: Tensor, ambient: float,
          out: Tensor | None, grad_out: Tensor | None = None,
          grads=(None,) * 4) -> _Args:
    """Check the inputs and pack the kernels' arguments (the planes' and
    the chunk's fields are set per launch; the pre-pass alone takes no
    transfer function and no image)."""
    dev = vol_p.device
    if dev.type != "cuda":
        raise ValueError(f"the volume is on {dev}; the sweep kernels take "
                         "CUDA tensors")
    na, nc, nb = vol_p.shape if vol_p.dim() == 3 else (-1, -1, -1)
    na2, nc2, nb2 = light_p.shape[:3] if light_p.dim() == 4 else (-1,) * 3
    s, n_u, n_v = c.fz.shape[0], u.shape[0], v.shape[0]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for name, t, dtype, shape in (
            ("vol_p", vol_p, f32, (na, nc, nb)),
            ("light_p", light_p, f32, (na2, nc2, nb2, 3)),
            ("k0", c.k0, i64, (s,)), ("k1", c.k1, i64, (s,)),
            ("fz", c.fz, f32, (s,)), ("lk0", c.lk0, i64, (s,)),
            ("lk1", c.lk1, i64, (s,)), ("lfz", c.lfz, f32, (s,)),
            ("valid", c.valid, f32, (s,)),
            ("w_planes", c.w_planes, f32, (s,)),
            ("u", u, f32, (n_u,)), ("v", v, f32, (n_v,)),
            ("dl", c.dl, f32, (n_v, n_u)), ("o_b", c.o_b, f32, ()),
            ("o_c", c.o_c, f32, ()), ("nonfinite", c.nonfinite, i32, (s,)),
            ("lnonfinite", c.lnonfinite, i32, (s, 3))):
        _check(name, t, dtype, shape, dev)
    for name, t in (("out", out), ("grad_out", grad_out)):
        if t is not None:
            _check(name, t, f32, (n_v, n_u, 4), dev)
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    p = 0
    if tf_pos is not None:
        p = tf_pos.shape[0]
        _check("tf positions", tf_pos, f32, (p,), dev)
        _check("tf colours", tf_col, f32, (p, 4), dev)
        if p < 1:
            raise ValueError("the sweep kernels take a transfer function of "
                             "at least one point")
        if tf_col.data_ptr() % 16:
            raise ValueError("tf colours must be 16-byte aligned")
    if min(na, nc, nb, na2, nc2, nb2) < 1:
        raise ValueError("an empty volume or light volume")
    if max(vol_p.numel(), light_p.numel(), n_v * n_u * 4) >= 2 ** 31:
        raise ValueError("a volume or image too large for 32-bit offsets")
    return _Args(
        *(_ptr(t) for t in (vol_p, light_p, tf_pos, tf_col, c.k0, c.k1, c.fz,
                            c.lk0, c.lk1, c.lfz, c.valid, c.w_planes, u, v,
                            c.dl, c.o_b, c.o_c, c.nonfinite, c.lnonfinite,
                            out, grad_out, *grads)), *(None,) * 12,
        na, nc, nb, na2, nc2, nb2, p, s, n_u, n_v, 0, s, 1, 1, 0,
        float(c.sbi), float(ambient))


def _launch(fn, args: _Args, dev, what: str) -> None:
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep scan {what} kernel: CUDA error {err}")


def _scratch(args: _Args, n: int, dev, grad: bool = False,
             carry: bool = False) -> tuple[Tensor, tuple]:
    """Room for ``n`` prepared planes in one allocation, with ``grad`` also
    their gradient planes and with ``carry`` the rays' (V, U, 4) carry, its
    fields' pointers set in ``args`` (``_PLANE_ARGS``, then ``_GRAD_ARGS``,
    then ``carry``): (the buffer, the fields' (dtype, shape))."""
    fields = _plane_fields(n, args.nc, args.nb, args.nc2, args.nb2, args.n_u,
                           args.n_v)
    names = _PLANE_ARGS
    if grad:
        fields += _grad_fields(n, args.nc, args.nb, args.nc2, args.nb2)
        names += _GRAD_ARGS
    if carry:
        fields += ((torch.float32, (args.n_v, args.n_u, 4)),)
        names += ("carry",)
    if max(math.prod(shape) for _, shape in fields) >= 2 ** 31:
        raise ValueError("a chunk of planes too large for 32-bit offsets")
    buf = torch.empty(sum(_field_bytes(shape) for _, shape in fields),
                      dtype=torch.uint8, device=dev)
    at = buf.data_ptr()
    for name, (_, shape) in zip(names, fields):
        setattr(args, name, at)
        at += _field_bytes(shape)
    return buf, fields


def _views(buf: Tensor, fields: tuple) -> tuple:
    """The fields that ``buf`` holds, in order: those of a
    :class:`Planes`, then the gradient planes and the carry where it has
    them."""
    out, at = [], 0
    for dtype, shape in fields:
        n = 4 * math.prod(shape)
        out.append(buf[at:at + n].view(dtype).view(shape))
        at += _field_bytes(shape)
    return tuple(out)


def sweep_planes(args: _Args, lo: int, hi: int, dev) -> None:
    """One launch of the pre-pass kernel: planes ``lo`` to ``hi`` of the
    scan that ``args`` describes, into the scratch that it points at."""
    args.k_lo, args.k_hi = lo, hi
    _launch(_library().cpm_sweep_planes, args, dev, "plane pre-pass")
    telemetry.launched("sweep_planes")


def _forward(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor, tf_col: Tensor,
             c, u: Tensor, v: Tensor, ambient: float) -> tuple:
    """:func:`sweep_scan_forward`, with the scratch it filled: (the
    intermediate image, (the scratch, its fields, the last chunk's [lo, hi)
    planes) or None where nothing was marched); :func:`_filled` reads
    it."""
    dev = vol_p.device
    out = torch.empty((v.shape[0], u.shape[0], 4), dtype=torch.float32,
                      device=dev)
    args = _args(vol_p, light_p, tf_pos, tf_col, c, u, v, ambient, out)
    plan = chunk_plan(args.n_planes, plane_bytes(
        args.nc, args.nb, args.nc2, args.nb2, args.n_u, args.n_v),
        PLANE_BUDGET)
    if out.numel() == 0 or not plan:
        return out.zero_(), None
    buf, fields = _scratch(args, max(hi - lo for lo, hi in plan), dev)
    lib = _library()  # ``buf`` is held until every launch is enqueued
    for i, (lo, hi) in enumerate(plan):
        sweep_planes(args, lo, hi, dev)
        args.first, args.last = int(i == 0), int(i == len(plan) - 1)
        _launch(lib.cpm_sweep_scan, args, dev, "forward")
        telemetry.launched("sweep_scan_forward")
    return out, (buf, fields, plan[-1])


def _filled(scratch: tuple) -> tuple[Planes, tuple[int, int]]:
    """The last chunk's :class:`Planes` in a forward's scratch, and its
    [lo, hi) planes."""
    buf, fields, (lo, hi) = scratch
    views = _views(buf, fields)[:len(Planes._fields)]
    return Planes(*(t[:hi - lo] for t in views)), (lo, hi)


def sweep_scan_forward(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor,
                       tf_col: Tensor, c, u: Tensor, v: Tensor,
                       ambient: float) -> Tensor:
    """The (V, U, 4) intermediate image: per chunk of planes
    (:func:`chunk_plan` under ``PLANE_BUDGET`` bytes) one pre-pass launch
    and one march launch, one thread per ray.

    ``vol_p`` (na, nc, nb) and ``light_p`` (na2, nc2, nb2, 3) are the
    volumes permuted to the marching axis, float32, contiguous; ``tf_pos``
    (P,) and ``tf_col`` (P, 4) the transfer function's points; ``c`` the
    scan's :class:`~cpm_tpu_torch.ops.sweep_render.ScanConstants`; ``u``
    (U,) and ``v`` (V,) the base-grid columns and rows, all on one CUDA
    device. A plane whose slab holds a non-finite texel gives NaN where
    the plain loop's matrix products do (``c.nonfinite``,
    ``c.lnonfinite``). Nothing is read back to the host."""
    return _forward(vol_p, light_p, tf_pos, tf_col, c, u, v, ambient)[0]


def sweep_fold(args: _Args, dev) -> None:
    """One launch of the fold kernel: the gradient planes of the chunk that
    ``args`` describes, added into the gradients of the slabs whose lerps
    made those planes."""
    _launch(_library().cpm_sweep_fold, args, dev, "fold")
    telemetry.launched("sweep_fold")


def _backward(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor,
              tf_col: Tensor, c, u: Tensor, v: Tensor, ambient: float,
              out: Tensor, grad_out: Tensor, needs=(True,) * 4) -> tuple:
    """:func:`sweep_scan_backward`, with the scratch it filled: (the
    gradients, (the scratch, its fields, the last chunk's [lo, hi) planes)
    or None where nothing was launched); :func:`_grad_planes` reads it."""
    dev = vol_p.device
    grads = tuple(torch.zeros_like(t) if need else None for t, need in zip(
        (vol_p, light_p, tf_pos, tf_col), needs))
    args = _args(vol_p, light_p, tf_pos, tf_col, c, u, v, ambient, out,
                 grad_out, grads)
    args.tf_shared = int(5 * 4 * args.tf_n <= TF_SHARED_BYTES)
    plan = chunk_plan(args.n_planes, grad_plane_bytes(
        args.nc, args.nb, args.nc2, args.nb2, args.n_u, args.n_v),
        PLANE_BUDGET)
    if out.numel() == 0 or not any(needs) or not plan:
        return grads, None
    buf, fields = _scratch(args, max(hi - lo for lo, hi in plan), dev,
                           grad=True, carry=len(plan) > 1)
    # A gradient plane that is not asked for is neither zeroed, nor added
    # into, nor folded.
    for name, grad in zip(_GRAD_ARGS, grads):
        if grad is None:
            setattr(args, name, None)
    lib = _library()  # ``buf`` is held until every launch is enqueued
    for i, (lo, hi) in enumerate(plan):
        sweep_planes(args, lo, hi, dev)
        args.first, args.last = int(i == 0), int(i == len(plan) - 1)
        _launch(lib.cpm_sweep_scan_grad, args, dev, "backward")
        telemetry.launched("sweep_scan_backward")
        sweep_fold(args, dev)
    return grads, (buf, fields, plan[-1])


def _grad_planes(scratch: tuple) -> tuple:
    """The last chunk's gradient planes in a backward's scratch, the
    volume's (S, nc, nb) and the light's (S, nc2, nb2, 4), and its [lo, hi)
    planes."""
    buf, fields, (lo, hi) = scratch
    g_vol, g_light = _views(buf, fields)[len(Planes._fields):][:2]
    return g_vol[:hi - lo], g_light[:hi - lo], (lo, hi)


def sweep_scan_backward(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor,
                        tf_col: Tensor, c, u: Tensor, v: Tensor,
                        ambient: float, out: Tensor, grad_out: Tensor,
                        needs=(True,) * 4) -> tuple:
    """The gradients (vol_p, light_p, tf positions, tf colours) for the
    cotangent ``grad_out`` of the forward's ``out``: per chunk of planes
    (:func:`chunk_plan` under ``PLANE_BUDGET`` bytes of
    :func:`grad_plane_bytes` each) the pre-pass, the gradient march (one
    thread a ray, into the chunk's gradient planes) and the fold (the
    gradient planes into the slabs), one launch each. An entry of
    ``needs`` that is False gives None and is not computed. The gradients
    are sums of atomic adds, whose order changes from run to run."""
    return _backward(vol_p, light_p, tf_pos, tf_col, c, u, v, ambient, out,
                     grad_out, needs)[0]


class SweepScan(torch.autograd.Function):
    """The forward kernels, differentiable in the volume, the light volume
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
        grad_out = grad_out.contiguous()
        if grad_out.data_ptr() % 16:
            grad_out = grad_out.clone()
        grads = sweep_scan_backward(
            vol_p, light_p, tf_pos, tf_col, ctx.c, u, v, ctx.ambient, out,
            grad_out, ctx.needs_input_grad[:4])
        return (*grads, None, None, None, None)


def sweep_scan(vol_p: Tensor, light_p: Tensor, tf_pos: Tensor,
               tf_col: Tensor, c, u: Tensor, v: Tensor,
               ambient: float) -> Tensor:
    """The plane scan on the card: the forward kernels, through
    :class:`SweepScan` where autograd records a gradient of the volume,
    the light volume or the transfer function. ``u`` and ``v`` are made
    contiguous (a rank's columns may be a strided slice), the colours
    16-byte aligned; a constant or a ray coordinate that requires grad
    raises."""
    if vol_p.device.type != "cuda":
        raise ValueError(f"the volume is on {vol_p.device}; the sweep "
                         "kernels take CUDA tensors")
    fixed = {"u": u, "v": v, **{f: t for f, t in c._asdict().items()
                                if isinstance(t, Tensor)}}
    for name, t in fixed.items():
        if t.requires_grad:
            raise ValueError(f"the sweep kernels do not differentiate {name}")
    u, v = u.contiguous(), v.contiguous()
    tf_col = tf_col.contiguous()
    if tf_col.data_ptr() % 16:
        tf_col = tf_col.clone()
    inputs = (vol_p, light_p, tf_pos.contiguous(), tf_col)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return SweepScan.apply(*inputs, c, u, v, ambient)
    return sweep_scan_forward(*inputs, c, u, v, ambient)

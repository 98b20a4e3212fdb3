"""The product-Epanechnikov photon splat: the Hopper kernels
(``csrc/splat_product.cu``), their wrappers, the brick geometry they share
with the CUDA source, and the plain PyTorch versions.

It replaces ``cpm_tpu/pallas/splat_mxu.py:_splat_kernel``. The source is
compiled with ``nvcc`` for ``sm_90a`` at first use into a shared library
with a plain C interface under ``cpm_tpu_torch/build/`` and loaded with
ctypes, by the port's one build routine (``kernels/_build.py``). Nothing
is built or imported for CUDA when this module is imported.

:func:`splat_product` takes CPU tensors to :func:`splat_product_torch` and
CUDA tensors to one of two kernel designs, chosen from the deposits per
output cell (:func:`choose_design`): :func:`splat_product_direct` (one
thread per deposit, global atomics) or :func:`splat_product_tiled`
(:func:`bin_deposits` sorts the deposits by output brick, then one block
per brick combines them in shared memory and adds its tile to the grid
once). Tensors on another device, or of another type, shape or layout,
raise.

The splat's backward with respect to the powers is its transpose,
:func:`splat_product_grad`: CPU tensors go to
:func:`splat_product_grad_torch`, CUDA tensors to the gather kernel
``splat_grad_kernel`` (one thread per slot gathering the grid gradient
over its window, the cell centres divided once a block into shared
memory; no atomics). The Pallas kernel has none: the reference
differentiates an XLA splat.
:class:`SplatProduct` joins the forward and this backward for autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.types import full_fp32_matmul
from cpm_tpu_torch.kernels import _build

Tensor = torch.Tensor

# Ratio of the radial Epanechnikov mass (2*pi*r^3/5) to the product kernel
# mass (r^3), so both deposit the same expected irradiance.
PRODUCT_KERNEL_MATCH = 0.4 * math.pi

SOURCE = _build.CSRC / "splat_product.cu"
NVCC_FLAGS = _build.BASE_FLAGS


def inverse_radius(radius_rel: float) -> np.float32:
    """1 / r in float32, as both kernels compute it."""
    return np.float32(1.0) / np.float32(radius_rel)


def voxel_centres(n: int, device) -> Tensor:
    """(i + 0.5) / n for i < n, each a correctly rounded float32 division as
    the kernel computes it. Made on the host: a CUDA tensor divided by a
    Python number is multiplied by the rounded reciprocal instead, which
    moves a centre by an ulp and, through the cancellation in 1 - d^2, a
    weight at the edge of the support by ~1e-5."""
    c = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    return torch.from_numpy(c).to(device)


def _axis_kernels(positions: Tensor, inv_r: float, centres: tuple):
    """(Kz, Ky, Kx): each deposit's weight at every cell centre of each
    axis, (M, D), (M, H), (M, W); ``centres`` are the (z, y, x) axes'
    :func:`voxel_centres`."""
    def kern(c, p):
        dist = (c[None, :] - p[:, None]) * inv_r
        return torch.clamp(0.75 * (1.0 - dist * dist), min=0.0)

    zc, yc, xc = centres
    return (kern(zc, positions[:, 2]), kern(yc, positions[:, 1]),
            kern(xc, positions[:, 0]))


def splat_product_torch(positions: Tensor, powers: Tensor,
                        radius_rel: float, out_dim: tuple,
                        chunk: int = 16384) -> Tensor:
    """Plain version: the separable kernel as a dense contraction per chunk
    of deposits, the twin of ``cpm_tpu.ops.splat.splat_product_xla``.
    ``powers`` already carry the scale and validity mask."""
    full_fp32_matmul()
    d, h, w = out_dim
    inv_r = float(inverse_radius(radius_rel))
    centres = tuple(voxel_centres(n, positions.device) for n in out_dim)
    acc = torch.zeros((d * h, w * 3), dtype=torch.float32,
                      device=positions.device)
    for lo in range(0, positions.shape[0], chunk):
        kz, ky, kx = _axis_kernels(positions[lo:lo + chunk], inv_r, centres)
        a = (kz[:, :, None] * ky[:, None, :]).reshape(-1, d * h)
        b = (kx[:, :, None] * powers[lo:lo + chunk, None, :]).reshape(
            -1, w * 3)
        acc.addmm_(a.T, b)
    return acc.reshape(d, h, w, 3)


def splat_product_grad_torch(positions: Tensor, grad: Tensor,
                             radius_rel: float, out_dim: tuple,
                             chunk: int = 16384) -> Tensor:
    """Plain version of the splat's backward: the (M, 3) gradient of the
    powers given the (D, H, W, 3) gradient of the grid,
    dP[m, c] = sum Kz Ky Kx G[z, y, x, c], as a dense contraction per chunk
    of deposits (the transpose of :func:`splat_product_torch`, which is
    autograd's result for it). Unused slots give 0."""
    full_fp32_matmul()
    d, h, w = out_dim
    inv_r = float(inverse_radius(radius_rel))
    centres = tuple(voxel_centres(n, positions.device) for n in out_dim)
    g = grad.reshape(d * h, w * 3)
    out = []
    for lo in range(0, positions.shape[0], chunk):
        kz, ky, kx = _axis_kernels(positions[lo:lo + chunk], inv_r, centres)
        a = (kz[:, :, None] * ky[:, None, :]).reshape(-1, d * h)
        t = (a @ g).reshape(-1, w, 3)
        out.append((kx[:, :, None] * t).sum(1))
    if not out:
        return grad.new_zeros((0, 3))
    return torch.cat(out)


# --- brick geometry, shared with csrc/splat_product.cu -------------------

BRICK = 8  # cells per axis of an output brick (kBrick)
SMEM_BYTES = 232448  # shared memory one block can use on an H100 (227 KB)
WINDOW_WIDTHS = (5, 8)  # window widths the kernels keep weights for
COUNT_THREADS = 256  # threads of a block of the counting passes
SEGMENT = 8192  # most deposits of one work item of the tiled splat
# The tiled design takes over from the direct one at this many deposit
# slots (used or not) per output cell. Set from the deposits of traced
# frames, of which 15-18% of the slots are used, timed by chip_smoke.py on
# an NVIDIA H100 80GB HBM3 (700 W) into 65^3: the direct design wins at
# 15 slots a cell (0.272 against 0.418 ms), the tiled one at 61 (0.694
# against 1.006 ms); between them both times are linear in the slots and
# cross near 30. (On seeded uniform deposits with 70% of the slots used
# the tiled design already wins from 1.9 a cell; the binning's cost follows
# the slots, the direct design's the used ones. The signed delta lists of
# correlated updates use about half their slots: every one a driven path
# splats, up to 6.1 slots a cell, is the direct design's (0.327 against
# 0.461 ms there), but at 12.2 a cell the tiled one already takes a fifth
# less (0.49 against 0.61 ms).)
TILED_MIN_DEPOSITS_PER_CELL = 30.0


def halo_cells(radius_rel: float, out_dim: tuple) -> int:
    """Cells a deposit's support can reach beyond the cell that holds the
    deposit, on the longest axis: ceil(r * n + 0.51). A window
    [floor((p - r) n - 0.5), ceil((p + r) n - 0.5)] leaves
    floor(p n) +- h only if frac(p n) < r n + 0.5 - h or
    frac(p n) > h + 0.5 - r n, so the 0.01 cell beyond r n + 0.5 is the
    margin for float32 rounding of the window's ends (~n * 2e-7 cells)."""
    return int(math.ceil(float(np.float32(radius_rel)) * max(out_dim)
                         + 0.51))


def window_width(radius_rel: float, out_dim: tuple) -> int:
    """The most cells a deposit's window holds per axis:
    ceil(2 r n) + 2 on the longest axis."""
    return int(math.ceil(2.0 * float(np.float32(radius_rel))
                         * max(out_dim))) + 2


def kernel_width(radius_rel: float, out_dim: tuple) -> int:
    """The smallest of WINDOW_WIDTHS that holds every window, or 0 (the
    direct kernel then recomputes weights; the tiled one does not run)."""
    need = window_width(radius_rel, out_dim)
    return next((w for w in WINDOW_WIDTHS if w >= need), 0)


def bricks_per_axis(out_dim: tuple) -> tuple:
    """Bricks along (z, y, x) of a (D, H, W) grid; the last may be ragged."""
    return tuple(-(-int(n) // BRICK) for n in out_dim)


def brick_count(out_dim: tuple) -> int:
    return math.prod(bricks_per_axis(out_dim))


def tile_cells(radius_rel: float, out_dim: tuple) -> int:
    """Cells per axis of a brick's shared-memory tile: the brick plus the
    halo on both sides."""
    return BRICK + 2 * halo_cells(radius_rel, out_dim)


def tile_smem_bytes(radius_rel: float, out_dim: tuple) -> int:
    """Shared memory of one tile: tile_cells^3 cells x 3 channels, fp32."""
    return tile_cells(radius_rel, out_dim) ** 3 * 3 * 4


def count_chunk(m: int) -> int:
    """Deposits per block of the counting passes: enough blocks to fill the
    card's 132 SMs twice over at small m, at most 8192 a block (every block
    touches every brick's counter once), a multiple of COUNT_THREADS."""
    chunk = min(8192, max(1024, -(-m // 264)))
    return -(-chunk // COUNT_THREADS) * COUNT_THREADS


def max_work_items(m: int, out_dim: tuple) -> int:
    """An upper bound on the work items of m deposits: every non-empty
    brick has at most one item that is not full."""
    return min(brick_count(out_dim), m) + m // SEGMENT


def tiled_fits(radius_rel: float, out_dim: tuple) -> bool:
    """Whether the tiled design can run: a tile and the counting passes'
    two histograms fit in a block's shared memory and the kernels keep
    weights for windows this wide."""
    return (tile_smem_bytes(radius_rel, out_dim) <= SMEM_BYTES
            and 2 * 4 * brick_count(out_dim) <= SMEM_BYTES
            and kernel_width(radius_rel, out_dim) != 0)


def choose_design(m: int, radius_rel: float, out_dim: tuple) -> str:
    """"tiled" where the deposits per output cell reach
    TILED_MIN_DEPOSITS_PER_CELL and the tiled design fits, else "direct"."""
    dense = m >= TILED_MIN_DEPOSITS_PER_CELL * math.prod(out_dim)
    return "tiled" if dense and tiled_fits(radius_rel, out_dim) else "direct"


def brick_keys(positions: Tensor, out_dim: tuple) -> Tensor:
    """Plain version of the kernels' brick key: for each (x, y, z) position
    the flat index (bz * nby + by) * nbx + bx of the brick that holds
    clamp(floor(p * n), 0, n - 1) per axis, or -1 for an unused slot
    (x >= 1e30 or NaN). int64, (M,)."""
    d, h, w = (int(n) for n in out_dim)
    nbz, nby, nbx = bricks_per_axis((d, h, w))
    dims = torch.tensor([w, h, d], dtype=torch.float32,
                        device=positions.device)
    cell = torch.nan_to_num(torch.floor(positions * dims), nan=0.0)
    cell = torch.clamp(cell, min=torch.zeros_like(dims), max=dims - 1.0)
    b = cell.to(torch.int64) // BRICK
    key = (b[:, 2] * nby + b[:, 1]) * nbx + b[:, 0]
    return torch.where(positions[:, 0] < 1e30, key, -1)


def bin_deposits_torch(positions: Tensor, out_dim: tuple):
    """Plain version of the binning: (counts, offsets, order). counts[b] is
    the number of live deposits of brick b, offsets its exclusive prefix
    sum with the total appended (nb + 1), and order the live deposits'
    indices sorted by brick, so brick b's segment is
    order[offsets[b]:offsets[b + 1]]."""
    keys = brick_keys(positions, out_dim)
    live = torch.nonzero(keys >= 0)[:, 0]
    counts = torch.bincount(keys[live], minlength=brick_count(out_dim))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    order = live[torch.argsort(keys[live], stable=True)]
    return counts, offsets, order


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source version) and return the shared
    library's path and the compiler's log."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library():
    """The built library with every entry point's argument types set."""
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cpm_splat_direct.argtypes = [ptr, ptr, i32, f32, f32, i32, i32, i32,
                                     i32, ptr, ptr]
    lib.cpm_bin_deposits.argtypes = [ptr, i32, i32, i32, i32, i32, i32, ptr,
                                     ptr, ptr]
    lib.cpm_splat_tiled.argtypes = [ptr, ptr, ptr, ptr, i32, f32, f32, i32,
                                    i32, i32, i32, i32, ptr, ptr]
    lib.cpm_splat_grad.argtypes = [ptr, ptr, i32, f32, f32, i32, i32, i32,
                                   i32, ptr, ptr]
    for fn in (lib.cpm_splat_direct, lib.cpm_bin_deposits,
               lib.cpm_splat_tiled, lib.cpm_splat_grad):
        fn.restype = ctypes.c_int
    return lib


def _check_deposits(name: str, t: Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"{name} must be (M, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.shape[0] >= 2 ** 31:
        raise ValueError("too many deposits for one launch")


def _check_grid(out_dim: tuple) -> None:
    if len(out_dim) != 3 or min(out_dim) < 1:
        raise ValueError(f"bad output shape {out_dim}")
    if math.prod(out_dim) * 3 >= 2 ** 31:
        raise ValueError(f"output shape {out_dim} is too large")


def _check_inputs(positions: Tensor, powers: Tensor, radius_rel: float,
                  out_dim: tuple) -> None:
    _check_deposits("positions", positions)
    _check_deposits("powers", powers)
    if powers.device != positions.device:
        raise ValueError("positions and powers lie on different devices")
    if powers.shape[0] != positions.shape[0]:
        raise ValueError("positions and powers differ in length")
    _check_grid(out_dim)
    if not (math.isfinite(radius_rel) and radius_rel > 0.0):
        raise ValueError(f"bad radius {radius_rel}")


def _check_cuda(t: Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"deposits are on {t.device}; the kernels take "
                         "CUDA tensors")


def _checked_cuda(positions: Tensor, powers: Tensor, radius_rel: float,
                  out_dim: tuple):
    """The checks of a splat kernel's wrapper: (float32 radius, (d, h, w));
    raises unless the deposits are well-formed CUDA tensors."""
    radius_rel = float(np.float32(radius_rel))
    _check_inputs(positions, powers, radius_rel, out_dim)
    _check_cuda(positions)
    return radius_rel, tuple(int(s) for s in out_dim)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def splat_product_direct(positions: Tensor, powers: Tensor,
                         radius_rel: float, out_dim: tuple) -> Tensor:
    """The direct design on CUDA tensors: one thread per deposit, global
    atomics. The recorder counts its launches
    (``telemetry.launches("splat_product_direct")``)."""
    r, (d, h, w) = _checked_cuda(positions, powers, radius_rel, out_dim)
    out = torch.empty((d, h, w, 3), dtype=torch.float32,
                      device=positions.device)
    with telemetry.span("splat.launch"), torch.cuda.device(positions.device):
        err = _library().cpm_splat_direct(
            positions.data_ptr(), powers.data_ptr(), positions.shape[0], r,
            float(inverse_radius(r)), d, h, w, kernel_width(r, (d, h, w)),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "direct splat kernel")
    telemetry.launched("splat_product_direct")
    return out




@telemetry.spanned("splat.bin")
def bin_deposits(positions: Tensor, out_dim: tuple):
    """The binning passes on a CUDA tensor of positions: (meta, order).
    ``order`` is (M,) int32 whose first entries are the live deposits'
    indices grouped by output brick; ``meta`` is the int32 scratch the
    tiled splat reads: counts [nb], cursors [nb], offsets [nb + 1], the
    number of work items [1] and the work items. The recorder counts its
    launches (``telemetry.launches("bin_deposits")``)."""
    _check_deposits("positions", positions)
    _check_grid(out_dim)
    _check_cuda(positions)
    d, h, w = (int(s) for s in out_dim)
    m = positions.shape[0]
    nb = brick_count((d, h, w))
    if 2 * 4 * nb > SMEM_BYTES:
        raise ValueError(f"{nb} bricks: the binning's histograms do not fit "
                         "in shared memory")
    dev = positions.device
    meta = torch.empty(3 * nb + 2 + 3 * max_work_items(m, (d, h, w)),
                       dtype=torch.int32, device=dev)
    order = torch.empty(m, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _library().cpm_bin_deposits(
            positions.data_ptr(), m, count_chunk(m), SEGMENT, d, h, w,
            meta.data_ptr(), order.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "binning kernels")
    telemetry.launched("bin_deposits")
    return meta, order




def splat_product_tiled(positions: Tensor, powers: Tensor, radius_rel: float,
                        out_dim: tuple) -> Tensor:
    """The tiled design on CUDA tensors: :func:`bin_deposits`, then one
    block per brick segment combines its deposits in a shared-memory tile
    and adds the tile to the grid once. Raises where a tile does not fit in
    shared memory. The recorder counts its launches
    (``telemetry.launches("splat_product_tiled")``)."""
    r, dim = _checked_cuda(positions, powers, radius_rel, out_dim)
    if not tiled_fits(r, dim):
        raise ValueError(
            f"radius {r} on {dim}: a tile of {tile_cells(r, dim)}^3 cells "
            f"({tile_smem_bytes(r, dim)} bytes) or the histograms of "
            f"{brick_count(dim)} bricks do not fit in shared memory")
    d, h, w = dim
    meta, order = bin_deposits(positions, dim)
    out = torch.empty((d, h, w, 3), dtype=torch.float32,
                      device=positions.device)
    with telemetry.span("splat.launch"), torch.cuda.device(positions.device):
        err = _library().cpm_splat_tiled(
            positions.data_ptr(), powers.data_ptr(), order.data_ptr(),
            meta.data_ptr(), max_work_items(positions.shape[0], dim), r,
            float(inverse_radius(r)), d, h, w, halo_cells(r, dim),
            kernel_width(r, dim), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "tiled splat kernel")
    telemetry.launched("splat_product_tiled")
    return out




def splat_product(positions: Tensor, powers: Tensor, radius_rel: float,
                  out_dim: tuple) -> Tensor:
    """Splat (M, 3) deposits into a (D, H, W, 3) grid with the
    product-Epanechnikov kernel; ``powers`` already carry the irradiance
    scale and validity mask, unused slots sit at positions >= 1e30.

    CPU tensors go to the plain version; CUDA tensors launch the design
    :func:`choose_design` names, whose wrapper counts the launch; tensors on
    any other device, or of another type, shape or layout, raise."""
    radius_rel = float(np.float32(radius_rel))
    _check_inputs(positions, powers, radius_rel, out_dim)
    dim = tuple(int(s) for s in out_dim)
    if positions.device.type == "cpu":
        return splat_product_torch(positions, powers, radius_rel, dim)
    if positions.device.type != "cuda":
        raise ValueError(f"deposits are on {positions.device}; the splat "
                         "takes CUDA tensors (kernel) or CPU tensors (plain "
                         "version)")
    if choose_design(positions.shape[0], radius_rel, dim) == "tiled":
        return splat_product_tiled(positions, powers, radius_rel, dim)
    return splat_product_direct(positions, powers, radius_rel, dim)


def _check_grid_grad(grad: Tensor, out_dim: tuple, device) -> None:
    if grad.dtype != torch.float32:
        raise TypeError(f"the grid gradient must be float32, got "
                        f"{grad.dtype}")
    if tuple(grad.shape) != (*out_dim, 3):
        raise ValueError(f"the grid gradient must be {(*out_dim, 3)}, got "
                         f"{tuple(grad.shape)}")
    if not grad.is_contiguous():
        raise ValueError("the grid gradient must be contiguous")
    if grad.device != device:
        raise ValueError("the grid gradient and the deposits lie on "
                         "different devices")


@functools.lru_cache(maxsize=64)
def _grad_constants(radius_rel: float, out_dim: tuple) -> tuple:
    """(float32 radius, its inverse, the kernel's window width) of a
    backward onto ``out_dim``; raises on a bad radius or grid."""
    r = float(np.float32(radius_rel))
    _check_grid(out_dim)
    if not (math.isfinite(r) and r > 0.0):
        raise ValueError(f"bad radius {radius_rel}")
    return r, float(inverse_radius(r)), kernel_width(r, out_dim)


def _checked_grad(positions: Tensor, grad: Tensor, radius_rel: float,
                  out_dim: tuple) -> tuple:
    """The backward's checks, each once: ((r, 1 / r, width), (d, h, w));
    raises unless the positions and the grid gradient are well-formed and
    on one device."""
    _check_deposits("positions", positions)
    dim = tuple(int(s) for s in out_dim)
    consts = _grad_constants(float(radius_rel), dim)
    _check_grid_grad(grad, dim, positions.device)
    return consts, dim


def _launch_grad(positions: Tensor, grad: Tensor, consts: tuple,
                 dim: tuple) -> Tensor:
    """``splat_grad_kernel`` on checked CUDA tensors, on the current
    stream of their device (entered only when it is not the current
    one)."""
    r, inv_r, width = consts
    d, h, w = dim
    if 4 * (d + h + w) > SMEM_BYTES:
        raise ValueError(f"grid {dim}: the backward kernel keeps its "
                         f"{d + h + w} cell centres in shared memory, at "
                         f"most {SMEM_BYTES // 4}")
    m = positions.shape[0]
    dev = positions.device
    out = torch.empty((m, 3), dtype=torch.float32, device=dev)

    def launch():
        return _library().cpm_splat_grad(
            positions.data_ptr(), grad.data_ptr(), m, r, inv_r, d, h, w,
            width, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    _raise_on(err, "splat backward kernel")
    telemetry.launched("splat_product_grad_cuda")
    return out


def splat_product_grad_cuda(positions: Tensor, grad: Tensor,
                            radius_rel: float, out_dim: tuple) -> Tensor:
    """The splat's backward on CUDA tensors: ``splat_grad_kernel``, one
    thread per slot gathering the grid gradient over its window; raises
    for a grid whose d + h + w cell centres pass a block's shared memory.
    The recorder counts its launches
    (``telemetry.launches("splat_product_grad_cuda")``)."""
    consts, dim = _checked_grad(positions, grad, radius_rel, out_dim)
    _check_cuda(positions)
    return _launch_grad(positions, grad, consts, dim)




def splat_product_grad(positions: Tensor, grad: Tensor, radius_rel: float,
                       out_dim: tuple) -> Tensor:
    """The (M, 3) gradient of a splat's powers given its grid's gradient
    (D, H, W, 3): CPU tensors go to the plain version, CUDA tensors launch
    the backward kernel; anything else raises."""
    consts, dim = _checked_grad(positions, grad, radius_rel, out_dim)
    if positions.device.type == "cpu":
        return splat_product_grad_torch(positions, grad, consts[0], dim)
    _check_cuda(positions)
    return _launch_grad(positions, grad, consts, dim)


class SplatProduct(torch.autograd.Function):
    """:func:`splat_product` with its backward with respect to the powers
    (:func:`splat_product_grad`, the kernel on a card). Positions are
    samples, not parameters: a position that requires grad raises rather
    than have its gradient dropped."""

    @staticmethod
    def forward(ctx, positions: Tensor, powers: Tensor, radius_rel: float,
                out_dim: tuple) -> Tensor:
        if positions.requires_grad:
            raise ValueError("SplatProduct differentiates the powers only; "
                             "detach the positions")
        ctx.save_for_backward(positions)
        ctx.radius_rel, ctx.out_dim = radius_rel, out_dim
        return splat_product(positions, powers, radius_rel, out_dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: Tensor):
        positions, = ctx.saved_tensors
        dpw = None
        if ctx.needs_input_grad[1]:
            dpw = splat_product_grad(positions, grad.contiguous(),
                                     ctx.radius_rel, ctx.out_dim)
        return None, dpw, None, None

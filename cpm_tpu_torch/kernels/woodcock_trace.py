"""The Woodcock trace on Hopper (``csrc/woodcock_trace.cu``): the
wrappers of its majorant grids' pre-pass and of the trace kernel, one call
each per trace on CUDA tensors.

They replace ``cpm_tpu/ops/tracer.py:trace_photons`` (:255-601), the
``lax.while_loop`` with its brick table and staged compaction, and its
``_majorant_grids`` (:165-176), which the port's plain versions
(``ops/tracer.py``: the wavefront loop, one torch step per flight, and
``majorant_grids_torch``) run as torch operators. The source is compiled
with ``nvcc`` for ``sm_90a`` at first use by the port's one build routine
(``kernels/_build.py``), with ``--fmad=false`` so that every product and
sum rounds on its own, as torch's one operator per launch does, and loaded
with ctypes. Nothing is built or imported for CUDA when this module is
imported.

:func:`trace_grids_cuda` builds the grids of one trace (three launches)
as one interleaved (majorant, distance) table and returns its two halves
and the largest majorant; the recorder (``core/telemetry.py``) counts its
calls under its name.
:func:`trace_woodcock_cuda` takes the constants of one trace
(``ops/tracer.trace_constants``) and the light samples as CUDA tensors,
checks them, allocates the outputs with the reference's sentinels, chooses
the launch (:func:`launch_shape`, from the card's SMs and the kernel's
occupancy) and launches the kernel on the current stream. Both raise on
tensors of another device, type, shape or layout and on a launch that
fails; the recorder counts its launches under its name and
``.last_shape`` is the last one's :class:`LaunchShape`.

Transfer functions of any size: a block keeps both transfer functions'
points and opacities in shared memory where they fit beside the rest of
its dynamic shared memory (:func:`tf_in_shared`, against the card's opt-in
limit less the kernel's static arrays), else both kernels read them from
device memory (a contiguous copy of the opacities, one device operation a
call). The choice is made before the launch.
``ops/tracer.py`` dispatches to them (``method="auto"`` on CUDA tensors,
or ``"cuda"``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.kernels import _build

Tensor = torch.Tensor

SOURCE = _build.CSRC / "woodcock_trace.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "--fmad=false")
HISTORY = 512  # active-count slots of the statistics

# Threads of a trace block, the widest that still gives every SM a block;
# flights between two compactions of a block's live lanes where a list
# holds more lanes than the card keeps resident (0: never). Chosen with
# scripts/ab_trace.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6):
# compacting every 4 flights made the default frame 0.1176-0.1187 ms
# against 0.1081-0.1087 without; blocks of 256 made it 0.1036-0.1039
# against 0.1067-0.1069 for 128 (config 3: 0.1831-0.1845 against
# 0.1879-0.1901); on the large frame, compacting every 8 flights in the
# resident blocks of 256 took 2.6246-2.6622 ms against 2.8913-2.8960
# with one thread a lane.
BLOCKS = (256, 128, 64, 32)
COMPACT_EVERY = 8
LANE_WORDS = 24  # a lane's state in the compaction's staging area
# What the library returns where a block would need more shared memory
# than the card gives one (a row of cells of the grids).
TOO_MUCH_SHARED = -100000
# The kernels of cpm_woodcock_shared_limit: the trace and the grids'
# majorant kernel.
TRACE_KERNEL, GRIDS_KERNEL = 0, 1


class _Args(ctypes.Structure):
    """``struct TraceArgs`` of the source, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "volume", "table", "maj_global", "tf_pos", "tf_opa", "tfs_pos",
        "tfs_opa", "origins", "directions", "powers", "tspan", "lane_ids",
        "out_pos", "out_pow", "out_dir", "exit_power", "exit_dir", "evt_pos",
        "evt_maj", "evt_type", "n_evt", "hist", "max_active",
        "warp_flights", "next_lane")] + [
        (name, ctypes.c_int) for name in (
            "n", "d", "h", "w", "gz", "gy", "gx", "tf_n", "tfs_n",
            "tf_stride", "tfs_stride")] + [
        ("k0", ctypes.c_uint), ("k1", ctypes.c_uint),
        ("max_i", ctypes.c_int), ("step_limit", ctypes.c_int),
        ("cell_shift", ctypes.c_int), ("cell_mul", ctypes.c_uint)] + [
        (name, ctypes.c_int) for name in (
            "ring", "phase_type", "nss", "clipped", "record_events",
            "compact_every", "tf_global")] + [
        ("vdims", ctypes.c_float * 3), ("cell_ext", ctypes.c_float * 3),
        ("clip_lo", ctypes.c_float * 3), ("clip_hi", ctypes.c_float * 3),
        ("step_size", ctypes.c_float), ("sbi", ctypes.c_float),
        ("cell_min_ext", ctypes.c_float), ("phase_g", ctypes.c_float),
        ("inv_max_i", ctypes.c_float), ("counts", ctypes.c_void_p)]


class _GridArgs(ctypes.Structure):
    """``struct GridArgs`` of the source, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "volume", "tf_pos", "tf_opa", "minmax", "row_max", "dx", "table",
        "maj_global")] + [(name, ctypes.c_int) for name in (
            "d", "h", "w", "gz", "gy", "gx", "tf_n", "tf_stride", "cell",
            "ring", "cap", "tf_global")] + [("tau", ctypes.c_float)]


class LaunchShape(NamedTuple):
    """How one trace is launched: ``grid`` blocks of ``block`` threads.
    Block b starts with lanes [b * block, (b + 1) * block); with
    compaction (``compact_every`` > 0) the threads it frees take the lanes
    from grid * block on, in the order a global counter hands them out."""

    block: int
    grid: int
    compact_every: int


def launch_shape(n: int, sms: int, per_sm) -> LaunchShape:
    """The launch of a trace of ``n`` lanes on a card of ``sms`` SMs, where
    ``per_sm(block)`` blocks of ``block`` threads fit on one SM: the widest
    block of :data:`BLOCKS` that still gives every SM a block (a retrace of
    a few thousand lanes spreads over all of them). Where those blocks are
    more than the card keeps resident and :data:`COMPACT_EVERY` is not 0,
    the card's resident blocks, compacting their lanes every
    :data:`COMPACT_EVERY` flights and taking the lanes past them as threads
    free up; else one thread a lane."""
    block = next((b for b in BLOCKS if -(-n // b) >= sms), BLOCKS[-1])
    blocks = -(-n // block)
    resident = sms * max(1, per_sm(block))
    if COMPACT_EVERY <= 0 or block <= 32 or blocks <= resident:
        return LaunchShape(block, blocks, 0)
    return LaunchShape(block, resident, COMPACT_EVERY)


class TraceOutputs(NamedTuple):
    """What one launch writes. Deposits are interaction-major, the layout
    of ``PhotonData``; the tape's and the statistics' tensors are None
    where they were not asked for."""

    positions: Tensor  # (I, N, 3) float32, FLT_MAX where unused
    powers: Tensor  # (I, N, 3) float32, zeros where unused
    directions: Tensor  # (I, N, 2) float32, zeros where unused
    exit_power: Tensor  # (N,) float32, FLT_MAX after an absorption
    exit_direction: Tensor  # (N, 2) float32
    evt_pos: Tensor | None  # (N, E, 3) float32
    evt_maj: Tensor | None  # (N, E) float32
    evt_type: Tensor | None  # (N, E) int32
    n_evt: Tensor | None  # (N,) int32
    active_history: Tensor | None  # (512,) int32
    max_active: Tensor | None  # (1,) int32, most flights of a lane
    warp_flights: Tensor | None  # (1,) int64, a warp's passes of a flight


def build() -> tuple[Path, str]:
    """Compile the kernels (once per source version) and return the shared
    library's path and the compiler's log."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    lib.cpm_woodcock_trace.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.cpm_woodcock_trace.restype = ctypes.c_int
    lib.cpm_woodcock_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int]
    lib.cpm_woodcock_occupancy.restype = ctypes.c_int
    lib.cpm_woodcock_shared_limit.argtypes = [ctypes.c_int]
    lib.cpm_woodcock_shared_limit.restype = ctypes.c_int
    lib.cpm_trace_grids.argtypes = [ctypes.POINTER(_GridArgs),
                                    ctypes.c_void_p]
    lib.cpm_trace_grids.restype = ctypes.c_int
    return lib


def _too_much_shared(what: str) -> ValueError:
    return ValueError(f"{what} need more shared memory than a block of "
                      "this card has")


def tf_in_shared(tf_bytes: int, other_bytes: int, limit: int) -> bool:
    """The rule that places a block's transfer functions: in shared
    memory where their ``tf_bytes`` (8 a point: its position and opacity)
    and the block's ``other_bytes`` of dynamic shared memory (a trace's
    staging area, a row of the grids' cells) fit in ``limit``, the bytes a
    block of the kernel may take on the card (:func:`shared_limit`); else
    in device memory."""
    return tf_bytes + other_bytes <= limit


def trace_tf_in_shared(points: int, block: int, limit: int) -> bool:
    """Whether a trace block of ``block`` threads keeps the ``points``
    points of both transfer functions in shared memory: with its staging
    area counted whether or not the launch compacts, so that the occupancy
    that sizes the grid and the launch agree."""
    return tf_in_shared(8 * points, 4 * LANE_WORDS * block, limit)


def trace_smem(points: int, block: int, tf_shared: bool) -> int:
    """The dynamic shared memory of a trace block of ``block`` threads
    that sizes its grid: the points and opacities of both transfer
    functions where they are in shared memory, and the staging area."""
    return 8 * points * tf_shared + 4 * LANE_WORDS * block


@functools.cache
def shared_limit(index: int, kernel: int) -> int:
    """The dynamic shared memory a block of ``kernel`` (TRACE_KERNEL or
    GRIDS_KERNEL) may take on card ``index``: the card's opt-in limit a
    block less the kernel's static arrays."""
    with torch.cuda.device(index):
        got = _library().cpm_woodcock_shared_limit(kernel)
    if got < 0:
        raise RuntimeError(f"shared memory limit: CUDA error {-got}")
    return got


@functools.cache
def _per_sm(index: int, block: int, smem: int, tf_global: bool) -> int:
    """Resident trace blocks of ``block`` threads per SM of card
    ``index``, at ``smem`` bytes of dynamic shared memory, of the kernel
    that reads its transfer functions from device memory where
    ``tf_global``."""
    with torch.cuda.device(index):
        got = _library().cpm_woodcock_occupancy(block, smem, int(tf_global))
    if got == TOO_MUCH_SHARED:
        raise _too_much_shared(f"blocks of {block} threads and {smem} bytes "
                               "of transfer functions and staging")
    if got < 0:
        raise RuntimeError(f"trace kernel occupancy: CUDA error {-got}")
    return got


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, t: Tensor, dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_opacities(name: str, t: Tensor, n: int, device) -> int:
    """A transfer function's (n,) float32 opacities on ``device``, at any
    positive stride (a column of its colours); returns the stride."""
    if t.device != device or t.dtype != torch.float32 or t.dim() != 1 \
            or t.shape[0] != n or t.stride(0) < 1:
        raise ValueError(f"{name} must be ({n},) float32 on {device}")
    return t.stride(0)


def _ptr(t: Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _cell_divisor(cell: int, dims: tuple) -> tuple[int, int]:
    """(shift, multiplier) with which the kernel divides a voxel index
    v < max(dims) by ``cell``: v >> shift for a power of two, else the
    high word of v * ceil(2^32 / cell), exact while max(dims) * cell <=
    2^32."""
    if cell < 1:
        raise ValueError(f"a macrocell of {cell} voxels")
    if cell & (cell - 1) == 0:
        return cell.bit_length() - 1, 0
    if max(dims) * cell > 2 ** 32:
        raise ValueError(f"a volume of {dims} voxels in cells of {cell} is "
                         "too large for the kernel's cell index")
    return -1, -(-(2 ** 32) // cell)


def _table(maj: Tensor, dist: Tensor) -> Tensor:
    """What the kernel reads as its (gz, gy, gx, 2) table of (majorant,
    distance): where ``maj`` and ``dist`` are the two halves of the table
    :func:`trace_grids_cuda` wrote, ``maj`` itself (its data starts the
    table), else the two grids stacked."""
    gz, gy, gx = maj.shape
    if (dist.shape == maj.shape and maj.dtype == dist.dtype == torch.float32
            and maj.stride() == dist.stride() == (2 * gy * gx, 2 * gx, 2)
            and dist.data_ptr() == maj.data_ptr() + 4
            and maj.data_ptr() % 8 == 0):
        return maj
    return torch.stack((maj, dist), dim=-1).contiguous()


def trace_grids_cuda(volume: Tensor, tf_pos: Tensor, tf_opa: Tensor,
                     cell: int, ring: int, cap: int, tau: float):
    """The majorant grids of one trace on the card, three launches, nothing
    read back: (maj, dist, maj_global), ``ops/tracer.majorant_grids_torch``
    bit for bit. ``volume`` is the (D, H, W) float32 volume, contiguous;
    ``tf_pos`` the (P,) points and ``tf_opa`` their opacities (any stride,
    a column of the colours); ``cell`` voxels a macrocell axis, ``ring``
    cells of dilation, ``cap`` the distance cap and ``tau`` the float32
    factor of the majorants. ``maj`` and ``dist`` are the two (gz, gy, gx)
    halves of one interleaved table, which the trace kernel reads with one
    load; ``maj_global`` is a 0-d tensor. The recorder counts
    its calls, ``.tf_global`` whether the last one read the points
    from device memory (:func:`tf_in_shared`)."""
    dev = volume.device
    if dev.type != "cuda":
        raise ValueError(f"the volume is on {dev}; the grids' kernels take "
                         "CUDA tensors")
    if volume.dim() != 3 or min(volume.shape) < 1:
        raise ValueError(f"a (D, H, W) volume, got {tuple(volume.shape)}")
    d, h, w = (int(s) for s in volume.shape)
    _check("volume", volume, torch.float32, (d, h, w), dev)
    p = tf_pos.shape[0] if tf_pos.dim() == 1 else -1
    _check("tf_pos", tf_pos, torch.float32, (p,), dev)
    stride = _check_opacities("tf_opa", tf_opa, p, dev)
    if p < 1 or cell < 1 or ring < 0 or cap < 0:
        raise ValueError("bad transfer function, cell, ring or cap")
    gz, gy, gx = -(-d // cell), -(-h // cell), -(-w // cell)
    tf_global = not tf_in_shared(
        8 * p, 4 * gx, shared_limit(_device_index(dev), GRIDS_KERNEL))
    if tf_global:
        tf_opa, stride = tf_opa.contiguous(), 1
    cells = gz * gy * gx
    out = torch.empty(2 * cells + 1, dtype=torch.float32, device=dev)
    scratch = torch.empty(3 * cells + gz * gy, dtype=torch.float32,
                          device=dev)
    table = out[:2 * cells].view(gz, gy, gx, 2)
    maj_global = out[2 * cells]
    args = _GridArgs(
        volume.data_ptr(), tf_pos.data_ptr(), tf_opa.data_ptr(),
        scratch.data_ptr(), scratch[2 * cells:].data_ptr(),
        scratch[2 * cells + gz * gy:].data_ptr(), table.data_ptr(),
        maj_global.data_ptr(), d, h, w, gz, gy, gx, p, stride, cell, ring,
        cap, int(tf_global), float(np.float32(tau)))
    with torch.cuda.device(dev):
        err = _library().cpm_trace_grids(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err == TOO_MUCH_SHARED:
        raise _too_much_shared(f"rows of {gx} cells")
    if err != 0:
        raise RuntimeError(f"trace grids kernels: CUDA error {err}")
    telemetry.launched("trace_grids_cuda")
    trace_grids_cuda.tf_global = tf_global
    return table[..., 0], table[..., 1], maj_global


trace_grids_cuda.tf_global = None


def _prepare(c, volume: Tensor, origins: Tensor, directions: Tensor,
             powers: Tensor, tspan: Tensor, lane_ids: Tensor, key: tuple,
             record_events: int, return_stats: bool,
             counts: Tensor | None = None):
    """Check the inputs, allocate the outputs on their device with the
    reference's sentinels (FLT_MAX positions, zero powers and directions,
    a zeroed tape), choose the launch and pack the kernel's arguments:
    (arguments, launch shape, outputs, tensors the launch reads that no
    caller holds). ``counts``: the (2,) int64 counters the kernel adds
    its tentative and accepted collisions to, or None."""
    dev = volume.device
    n = origins.shape[0] if origins.dim() == 2 else -1
    d, h, w = c.shape
    gz, gy, gx = c.maj.shape
    f32 = torch.float32
    np_, nq = c.tf_pos.shape[0], c.tfs_pos.shape[0]
    for name, t, dtype, shape in (
            ("volume", volume, f32, (d, h, w)),
            ("maj_global", c.maj_global, f32, ()),
            ("tf_pos", c.tf_pos, f32, (np_,)),
            ("tfs_pos", c.tfs_pos, f32, (nq,)),
            ("origins", origins, f32, (n, 3)),
            ("directions", directions, f32, (n, 3)),
            ("powers", powers, f32, (n, 3)),
            ("tspan", tspan, f32, (n, 2)),
            ("lane_ids", lane_ids, torch.int64, (n,))):
        _check(name, t, dtype, shape, dev)
    for name, t in (("maj", c.maj), ("dist", c.dist)):
        if t.device != dev or t.dtype != f32 or t.shape != (gz, gy, gx):
            raise ValueError(f"{name} must be ({gz}, {gy}, {gx}) float32 "
                             f"on {dev}")
    tf_stride = _check_opacities("tf_opa", c.tf_opa, np_, dev)
    tfs_stride = _check_opacities("tfs_opa", c.tfs_opa, nq, dev)
    if min(np_, nq) < 1:
        raise ValueError("a transfer function without points")
    max_i = c.max_interactions
    if max_i < 1 or record_events < 0 or c.step_limit < 0:
        raise ValueError("bad interaction, tape or step limit")
    if n >= 2 ** 30:
        raise ValueError(f"{n} lanes are too many for one launch")
    cell_shift, cell_mul = _cell_divisor(c.cell_vox, c.shape)
    table = _table(c.maj, c.dist)

    big = float(np.finfo(np.float32).max)
    out_pos = torch.full((max_i, n, 3), big, dtype=f32, device=dev)
    out_pow = torch.zeros((max_i, n, 3), dtype=f32, device=dev)
    out_dir = torch.zeros((max_i, n, 2), dtype=f32, device=dev)
    exit_power = torch.empty(n, dtype=f32, device=dev)
    exit_dir = torch.empty((n, 2), dtype=f32, device=dev)
    evt_pos = evt_maj = evt_type = n_evt = None
    if record_events:
        evt_pos = torch.zeros((n, record_events, 3), dtype=f32, device=dev)
        evt_maj = torch.zeros((n, record_events), dtype=f32, device=dev)
        evt_type = torch.zeros((n, record_events), dtype=torch.int32,
                               device=dev)
        n_evt = torch.zeros(n, dtype=torch.int32, device=dev)
    hist = max_active = warp_flights = None
    if return_stats:
        # One zeroed buffer: the history, the most flights and (8-byte
        # aligned) the warps' passes.
        counters = torch.zeros(HISTORY + 4, dtype=torch.int32, device=dev)
        hist, max_active = counters[:HISTORY], counters[HISTORY:HISTORY + 1]
        warp_flights = counters[HISTORY + 2:].view(torch.int64)
    out = TraceOutputs(out_pos, out_pow, out_dir, exit_power, exit_dir,
                       evt_pos, evt_maj, evt_type, n_evt, hist, max_active,
                       warp_flights)

    # A block's shared memory: both transfer functions' points and
    # opacities where they fit (tf_in_shared), and the staging area of a
    # compaction.
    index = _device_index(dev)
    limit = shared_limit(index, TRACE_KERNEL)

    def per_sm(block: int) -> int:
        shared = trace_tf_in_shared(np_ + nq, block, limit)
        return _per_sm(index, block, trace_smem(np_ + nq, block, shared),
                       not shared)

    shape = launch_shape(n, _sms(index), per_sm)
    tf_global = not trace_tf_in_shared(np_ + nq, shape.block, limit)
    tf_opa, tfs_opa = c.tf_opa, c.tfs_opa
    if tf_global:
        tf_opa, tfs_opa = tf_opa.contiguous(), tfs_opa.contiguous()
        tf_stride = tfs_stride = 1
    next_lane = None
    if shape.compact_every and shape.grid * shape.block < n:
        next_lane = torch.empty(1, dtype=torch.int32, device=dev)

    def floats(v):
        return (ctypes.c_float * 3)(*v)

    args = _Args(
        *(_ptr(t) for t in (
            volume, table, c.maj_global, c.tf_pos, tf_opa, c.tfs_pos,
            tfs_opa, origins, directions, powers, tspan, lane_ids, *out,
            next_lane)),
        n, d, h, w, gz, gy, gx, np_, nq, tf_stride, tfs_stride,
        int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF, max_i,
        c.step_limit, cell_shift, cell_mul, c.ring, c.phase_type,
        int(c.no_single_scattering), int(c.clipped),
        # -1: no tape, but the lanes count their tests for the counters.
        record_events or (-1 if counts is not None else 0),
        shape.compact_every, int(tf_global),
        floats(c.vdims), floats(c.cell_ext), floats(c.clip_min),
        floats(c.clip_max), c.step_size, c.sbi, c.cell_min_ext, c.phase_g,
        float(np.float32(1.0) / np.float32(max_i)), _ptr(counts))
    return args, shape, out, (table, next_lane, tf_opa, tfs_opa)


def trace_woodcock_cuda(c, volume: Tensor, origins: Tensor,
                        directions: Tensor, powers: Tensor, tspan: Tensor,
                        lane_ids: Tensor, key: tuple,
                        record_events: int = 0,
                        return_stats: bool = False) -> TraceOutputs:
    """Trace N light samples in one launch (:func:`launch_shape`).

    ``c`` is the trace's :class:`~cpm_tpu_torch.ops.tracer.TraceConstants`,
    whose grids are read as one interleaved table (the one
    :func:`trace_grids_cuda` wrote, or the two grids stacked); ``volume``
    is the (D, H, W) float32 volume, contiguous; the light samples are
    (N, 3), (N, 3), (N, 3) and (N, 2) float32 and ``lane_ids`` (N,) int64
    (a lane draws the stream of the low 32 bits), all on one CUDA device.
    ``key`` is the (k0, k1) threefry key. With ``record_events=E`` the
    kernel writes each lane's first E acceptance tests; with
    ``return_stats`` the active lanes of each flight (at min(flight, 511)),
    the most flights a lane was active for and the passes warps made
    through a flight (32 of them over the active lane-flights is the
    kernel's SIMT efficiency). While the recorder records, the kernel adds
    its tentative collisions (acceptance tests) and accepted collisions
    (scatters and absorptions) to the recorder's device counters. Nothing
    is read back to the host."""
    dev = volume.device
    if dev.type != "cuda":
        raise ValueError(f"the volume is on {dev}; the trace kernel takes "
                         "CUDA tensors")
    with telemetry.span("trace.prepare"):
        counts = telemetry.device_counters(dev)
        args, shape, out, _keep = _prepare(c, volume, origins, directions,
                                           powers, tspan, lane_ids, key,
                                           record_events, return_stats,
                                           counts)
    if origins.shape[0] == 0:
        return out
    with telemetry.span("trace.launch"), torch.cuda.device(dev):
        err = _library().cpm_woodcock_trace(
            ctypes.byref(args), shape.grid, shape.block,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"Woodcock trace kernel: CUDA error {err}")
    telemetry.launched("trace_woodcock_cuda")
    trace_woodcock_cuda.last_shape = shape
    trace_woodcock_cuda.tf_global = bool(args.tf_global)
    return out


trace_woodcock_cuda.last_shape = None  # the LaunchShape of the last launch
# Whether the last launch read the transfer functions from device memory.
trace_woodcock_cuda.tf_global = None

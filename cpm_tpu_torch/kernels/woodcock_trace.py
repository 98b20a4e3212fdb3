"""The Woodcock trace as one Hopper kernel (``csrc/woodcock_trace.cu``):
its wrapper, which launches it once per trace on CUDA tensors.

It replaces ``cpm_tpu/ops/tracer.py:trace_photons`` (:255-601), the
``lax.while_loop`` with its brick table and staged compaction, which the
port's plain version (``ops/tracer.py``, the wavefront loop) runs as one
torch step per flight. The source is compiled with ``nvcc`` for
``sm_90a`` at first use by the port's one build routine
(``kernels/_build.py``), with ``--fmad=false`` so that every product and
sum rounds on its own, as torch's one operator per launch does, and
loaded with ctypes. Nothing is built or imported for CUDA when this module
is imported.

:func:`trace_woodcock_cuda` takes the constants of one trace
(``ops/tracer.trace_constants``) and the light samples as CUDA tensors,
checks them, allocates the outputs with the reference's sentinels and
launches the kernel on the current stream. It raises on tensors of
another device, type, shape or layout and on a launch that fails;
``trace_woodcock_cuda.launches`` counts its launches. ``ops/tracer.py``
dispatches to it (``method="auto"`` on CUDA tensors, or ``"cuda"``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cpm_tpu_torch.kernels import _build

Tensor = torch.Tensor

SOURCE = _build.CSRC / "woodcock_trace.cu"
NVCC_FLAGS = (*_build.BASE_FLAGS, "--fmad=false")
HISTORY = 512  # active-count slots of the statistics

# Operations the kernel does per active lane and flight, counted from the
# source, for a bound: three threefry blocks of 20 rounds (an add, a
# rotation of two shifts and an or, and a xor a round; five key injections
# of three adds) and the uniforms' shift, or and subtract: 3 * (20 * 5 +
# 5 * 3 + 2 + 3) = 360 integer operations; about 200 float operations (the
# flight and its block exit ~45, the trilinear fetch ~45, two four-point
# transfer functions ~50, the interaction and its phase sampling ~60).
OPS_PER_FLIGHT = 360 + 200


class _Args(ctypes.Structure):
    """``struct TraceArgs`` of the source, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "volume", "maj", "dist", "maj_global", "tf_pos", "tf_opa", "tfs_pos",
        "tfs_opa", "origins", "directions", "powers", "tspan", "lane_ids",
        "out_pos", "out_pow", "out_dir", "exit_power", "exit_dir", "evt_pos",
        "evt_maj", "evt_type", "n_evt", "hist", "max_active")] + [
        ("n", ctypes.c_int), ("d", ctypes.c_int), ("h", ctypes.c_int),
        ("w", ctypes.c_int), ("gz", ctypes.c_int), ("gy", ctypes.c_int),
        ("gx", ctypes.c_int), ("tf_n", ctypes.c_int), ("tfs_n", ctypes.c_int),
        ("k0", ctypes.c_uint), ("k1", ctypes.c_uint),
        ("max_i", ctypes.c_int), ("step_limit", ctypes.c_int),
        ("cell_vox", ctypes.c_int), ("ring", ctypes.c_int),
        ("phase_type", ctypes.c_int), ("nss", ctypes.c_int),
        ("clipped", ctypes.c_int), ("record_events", ctypes.c_int),
        ("vdims", ctypes.c_float * 3), ("cell_ext", ctypes.c_float * 3),
        ("clip_lo", ctypes.c_float * 3), ("clip_hi", ctypes.c_float * 3),
        ("step_size", ctypes.c_float), ("sbi", ctypes.c_float),
        ("cell_min_ext", ctypes.c_float), ("phase_g", ctypes.c_float),
        ("inv_max_i", ctypes.c_float)]


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
    max_active: Tensor | None  # (1,) int32, most flights a lane was active


def build() -> tuple[Path, str]:
    """Compile the kernel (once per source version) and return the shared
    library's path and the compiler's log."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    lib.cpm_woodcock_trace.argtypes = [ctypes.POINTER(_Args),
                                       ctypes.c_void_p]
    lib.cpm_woodcock_trace.restype = ctypes.c_int
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


def _prepare(c, volume: Tensor, origins: Tensor, directions: Tensor,
             powers: Tensor, tspan: Tensor, lane_ids: Tensor, key: tuple,
             record_events: int, return_stats: bool):
    """Check the inputs, allocate the outputs on their device with the
    reference's sentinels (FLT_MAX positions, zero powers and directions,
    a zeroed tape) and pack the kernel's arguments: (arguments,
    outputs)."""
    dev = volume.device
    n = origins.shape[0] if origins.dim() == 2 else -1
    d, h, w = c.shape
    gz, gy, gx = c.maj.shape
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("volume", volume, f32, (d, h, w)),
            ("maj", c.maj, f32, (gz, gy, gx)),
            ("dist", c.dist, f32, (gz, gy, gx)),
            ("maj_global", c.maj_global, f32, ()),
            ("tf_pos", c.tf_pos, f32, (c.tf_pos.shape[0],)),
            ("tf_opa", c.tf_opa, f32, (c.tf_pos.shape[0],)),
            ("tfs_pos", c.tfs_pos, f32, (c.tfs_pos.shape[0],)),
            ("tfs_opa", c.tfs_opa, f32, (c.tfs_pos.shape[0],)),
            ("origins", origins, f32, (n, 3)),
            ("directions", directions, f32, (n, 3)),
            ("powers", powers, f32, (n, 3)),
            ("tspan", tspan, f32, (n, 2)),
            ("lane_ids", lane_ids, torch.int64, (n,))):
        _check(name, t, dtype, shape, dev)
    if min(c.tf_pos.shape[0], c.tfs_pos.shape[0]) < 1:
        raise ValueError("a transfer function without points")
    max_i = c.max_interactions
    if max_i < 1 or record_events < 0 or c.step_limit < 0:
        raise ValueError("bad interaction, tape or step limit")
    if n >= 2 ** 31:
        raise ValueError(f"{n} lanes are too many for one launch")

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
    hist = max_active = None
    if return_stats:
        hist = torch.zeros(HISTORY, dtype=torch.int32, device=dev)
        max_active = torch.zeros(1, dtype=torch.int32, device=dev)
    out = TraceOutputs(out_pos, out_pow, out_dir, exit_power, exit_dir,
                       evt_pos, evt_maj, evt_type, n_evt, hist, max_active)

    def floats(v):
        return (ctypes.c_float * 3)(*v)

    args = _Args(
        *(_ptr(t) for t in (
            volume, c.maj, c.dist, c.maj_global, c.tf_pos, c.tf_opa,
            c.tfs_pos, c.tfs_opa, origins, directions, powers, tspan,
            lane_ids, *out)),
        n, d, h, w, gz, gy, gx, c.tf_pos.shape[0], c.tfs_pos.shape[0],
        int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF, max_i,
        c.step_limit, c.cell_vox, c.ring, c.phase_type,
        int(c.no_single_scattering), int(c.clipped), record_events,
        floats(c.vdims), floats(c.cell_ext), floats(c.clip_min),
        floats(c.clip_max), c.step_size, c.sbi, c.cell_min_ext, c.phase_g,
        float(np.float32(1.0) / np.float32(max_i)))
    return args, out


def trace_woodcock_cuda(c, volume: Tensor, origins: Tensor,
                        directions: Tensor, powers: Tensor, tspan: Tensor,
                        lane_ids: Tensor, key: tuple,
                        record_events: int = 0,
                        return_stats: bool = False) -> TraceOutputs:
    """Trace N light samples in one launch, one thread per lane.

    ``c`` is the trace's :class:`~cpm_tpu_torch.ops.tracer.TraceConstants`;
    ``volume`` is the (D, H, W) float32 volume, contiguous; the light
    samples are (N, 3), (N, 3), (N, 3) and (N, 2) float32 and ``lane_ids``
    (N,) int64 (a lane draws the stream of the low 32 bits), all on one
    CUDA device. ``key`` is the (k0, k1) threefry key. With
    ``record_events=E`` the kernel writes each lane's first E acceptance
    tests; with ``return_stats`` the active lanes of each flight (at
    min(flight, 511)) and the most flights a lane was active for. Nothing
    is read back to the host."""
    dev = volume.device
    if dev.type != "cuda":
        raise ValueError(f"the volume is on {dev}; the trace kernel takes "
                         "CUDA tensors")
    args, out = _prepare(c, volume, origins, directions, powers, tspan,
                         lane_ids, key, record_events, return_stats)
    if origins.shape[0] == 0:
        return out
    with torch.cuda.device(dev):
        err = _library().cpm_woodcock_trace(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"Woodcock trace kernel: CUDA error {err}")
    trace_woodcock_cuda.launches += 1
    return out


trace_woodcock_cuda.launches = 0

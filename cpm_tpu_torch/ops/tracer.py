"""Photon tracer: Woodcock (delta) tracking through a TF-classified volume
with scattering, absorption and per-interaction photon deposition
(``cpm_tpu/ops/tracer.py:trace_photons``, :253-601), its chunked form
(:604-647) and the merge of a retraced subset back into the photon buffer
(:650-692).

Each lane runs the reference's per-lane state machine (:348-497):
macrocell majorants, flights clamped at the exit of the (2*ring+1)^3
block of cells, capped empty-space jumps, (lane, step)-keyed threefry
draws, and ``flights_per_iteration`` (K) flights between two tests of the
loop condition ``any(active) and step < max_steps``. Two forms run it,
chosen by ``method``, and both read one set of constants
(:func:`trace_constants`):

- the kernels (``"cuda"``, what ``"auto"`` takes for CUDA tensors):
  ``csrc/woodcock_trace.cu`` through ``kernels/woodcock_trace.py``, the
  majorant grids' pre-pass and one trace launch, one thread per lane,
  each running its own loop while it is active and its step is below
  K * ceil(max_steps / K);
- the wavefront loop (``"wavefront"``, what ``"auto"`` takes for CPU
  tensors) with :func:`majorant_grids_torch`, the kernels' plain
  versions: all lanes advance one flight per step as torch operators,
  with a host test of the loop condition every K flights.

The reference's packed brick table and staged lane compaction exist for
TPU gathers and leave the trajectories unchanged. Their GPU forms: the
volume is read with eight direct gathers per trilinear fetch, the
majorant and skip distance a lane carries are read at the brick column's
voxel quantization, ``grid[floor(clip(p*dim - 0.5)) // cell_size]``, and
a lane that has ended retires its thread; above the lanes the card keeps
resident, the kernel's blocks pack their live lanes and take new ones.

Options (``TracerConfig``): ``no_single_scattering`` turns each lane's
first collision into a scatter without a deposit (power divided by the
phase pdf, no albedo test), so only multiple scattering is stored;
``photon_dtype="float16"`` casts the three deposit fields at the end (the
trace itself runs in float32; FLT_MAX becomes +inf, which every
consumer's ``< 1e30`` test still reads as unused). ``return_stats`` adds
the loop's counters; ``record_events=E`` adds the event tape of the
trajectory gradients (:class:`TraceEvents`, read by ``ops/score_grad.py``).

While the recorder (``core/telemetry.py``) records, both forms count
their tentative collisions (acceptance tests) and accepted collisions
(scatters and absorptions) into its device counters, with no host wait.

The trace records no autograd graph (it runs under ``torch.no_grad``):
its sampling decisions are discrete, and ``ops/replay.py`` recomputes the
powers differentiably from what it stored.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cpm_tpu_torch.core import constants, telemetry
from cpm_tpu_torch.core.config import TracerConfig
from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      TransferFunction, Volume,
                                      encode_direction, f32_scalar,
                                      piecewise_opacity)
from cpm_tpu_torch.kernels import woodcock_trace
from cpm_tpu_torch.ops import intersect, majorant as majorant_mod, rng
from cpm_tpu_torch.ops import phase as phase_mod
from cpm_tpu_torch.ops.sampling import sample_volume_trilinear, voxel_coords

Tensor = torch.Tensor

# Nudge past a macrocell boundary: large vs float32 ulp at ~1.0, small vs
# a voxel.
_BOUNDARY_EPS = 1e-5

_HISTORY = 512  # active-count history slots when return_stats is on

# Event-tape type codes (cpm_tpu/ops/tracer.py:109-117; ops/score_grad.py
# reads them):
EVT_NULL = 0  # rejected flight: factor (1 - sigma/maj)
EVT_SCATTER = 1  # accepted and scattered: (sigma/maj) * albedo
EVT_ABSORB = 2  # accepted, absorbed by the albedo test:
#                 (sigma/maj) * (1 - albedo)
EVT_FORCED = 3  # accepted at the max_interactions cap: (sigma/maj) only
EVT_FIRST = 4  # accepted first event under no_single_scattering:
#                (sigma/maj) only


class TraceEvents(NamedTuple):
    """Per-lane tape of every Woodcock acceptance test a lane made: the
    trajectory's scene-dependent sampling decisions. ``counts`` may exceed
    the cap E, and then the lane's tape holds only its first E tests."""

    positions: Tensor  # (N, E, 3) float32, where each test was made
    majorants: Tensor  # (N, E) float32, the local majorant it used
    types: Tensor  # (N, E) int32, EVT_* (EVT_NULL where unwritten)
    counts: Tensor  # (N,) int32, tests made (may exceed E)


@telemetry.spanned("trace.grids")
def majorant_grids(volume: Volume, tf: TransferFunction,
                   config: TracerConfig, method: str = "auto"):
    """(maj, dist, maj_global, cell_min_ext): per-cell majorant opacity
    (times tau_max), the capped empty-space distance map, their global max
    (a 0-d tensor on the volume's device) and the texture extent of one
    skippable cell, a float32 value (tracer.py:164-176). ``method`` as in
    :func:`trace_photons`: the kernel form
    (``kernels/woodcock_trace.trace_grids_cuda``, three launches; ``maj``
    and ``dist`` are the halves of one interleaved table) for CUDA tensors,
    :func:`majorant_grids_torch` for any other. Without a majorant grid
    the grids are one constant cell, no kernel's work."""
    if _method(method, volume.device) == "wavefront" or \
            not config.use_majorant_grid:
        return majorant_grids_torch(volume, tf, config)
    maj, dist, maj_global = woodcock_trace.trace_grids_cuda(
        volume.data.contiguous(), tf.positions.detach().contiguous(),
        tf.colors[:, 3].detach(), config.majorant_cell_size,
        config.block_ring, config.empty_jump_cap, f32_scalar(config.tau_max))
    return maj, dist, maj_global, _cell_min_ext(maj)


def _cell_min_ext(maj: Tensor) -> float:
    return float(np.float32(1.0) / np.float32(max(maj.shape)))


def majorant_grids_torch(volume: Volume, tf: TransferFunction,
                         config: TracerConfig):
    """The plain version of :func:`majorant_grids`, as torch operators."""
    if config.use_majorant_grid:
        maj = majorant_mod.build_majorant_grid(
            volume, tf, config.majorant_cell_size, config.block_ring)
    else:
        maj = torch.ones((1, 1, 1), dtype=torch.float32,
                         device=volume.device)
    maj = maj * f32_scalar(config.tau_max)
    dist = majorant_mod.empty_distance_grid(maj, cap=config.empty_jump_cap)
    return maj, dist, torch.amax(maj), _cell_min_ext(maj)


class TraceConstants(NamedTuple):
    """What stays fixed during one trace (tracer.py:290-347): the host
    numbers as float32 values, the tables as tensors on the volume's
    device. Both the wavefront loop and the kernel's wrapper read them
    from here."""

    shape: tuple  # (D, H, W) of the volume
    vdims: tuple  # (W, H, D): texture to voxel scale per axis
    cell_vox: int  # voxels per macrocell axis
    cell_ext: tuple  # (x, y, z) texture extent of a macrocell
    step_size: float  # 1 / (sampling_rate * max dim)
    sbi: float  # SAMPLING_BASE_INTERVAL_RCP
    cell_min_ext: float  # texture extent of one skippable cell
    ring: int  # macrocells beside a lane's cell in its block
    clip_min: tuple  # (3,) clip box corners
    clip_max: tuple
    clipped: bool  # the clip box is not the unit cube
    phase_type: int
    phase_g: float
    tf_pos: Tensor  # (P,) the transfer function's points
    tf_opa: Tensor  # (P,) their opacities (a column of the colours)
    tfs_pos: Tensor  # (Q,) the scattering transfer function's
    tfs_opa: Tensor  # (Q,)
    maj: Tensor  # (gz, gy, gx) majorants (a view of the kernels' table)
    dist: Tensor  # (gz, gy, gx) empty-space distances, in cells
    maj_global: Tensor  # () their max, never read by the host
    max_interactions: int
    no_single_scattering: bool
    flights: int  # K, flights between two tests of the loop condition
    step_limit: int  # K * ceil(max_steps / K): no lane flies further


def trace_constants(volume: Volume, tf: TransferFunction,
                    tf_scattering: TransferFunction, config: TracerConfig,
                    grids: tuple | None = None,
                    method: str = "auto") -> TraceConstants:
    """The constants of one trace of ``volume`` under ``config``; ``grids``
    takes :func:`majorant_grids`' result where one build serves several
    traces, else they are built by ``method``. Numbers are rounded as the
    reference's float32 arithmetic rounds them; nothing is uploaded or
    read back."""
    if grids is None:
        grids = majorant_grids(volume, tf, config, method)
    maj, dist, maj_global, cell_min_ext = grids
    shape = tuple(int(s) for s in volume.shape_zyx)
    d_, h_, w_ = shape
    vdims = np.array([w_, h_, d_], np.float32)
    cell_ext = np.float32(config.majorant_cell_size) / vdims
    k = max(1, config.flights_per_iteration)
    return TraceConstants(
        shape=shape, vdims=tuple(float(v) for v in vdims),
        cell_vox=config.majorant_cell_size,
        cell_ext=tuple(float(v) for v in cell_ext),
        step_size=f32_scalar(1.0 / (config.sampling_rate * max(shape))),
        sbi=f32_scalar(constants.SAMPLING_BASE_INTERVAL_RCP),
        cell_min_ext=cell_min_ext, ring=config.block_ring,
        clip_min=tuple(f32_scalar(v) for v in config.clip_min),
        clip_max=tuple(f32_scalar(v) for v in config.clip_max),
        clipped=(config.clip_min != (0.0, 0.0, 0.0)
                 or config.clip_max != (1.0, 1.0, 1.0)),
        phase_type=config.phase_type, phase_g=f32_scalar(config.phase_g),
        tf_pos=tf.positions.detach().contiguous(),
        tf_opa=tf.colors[:, 3].detach(),
        tfs_pos=tf_scattering.positions.detach().contiguous(),
        tfs_opa=tf_scattering.colors[:, 3].detach(),
        maj=maj, dist=dist, maj_global=maj_global,
        max_interactions=config.max_interactions,
        no_single_scattering=config.no_single_scattering, flights=k,
        step_limit=k * -(-config.max_steps // k))


def _method(method: str, device: torch.device) -> str:
    """Resolve the trace's backend: "auto" is the kernel for CUDA tensors
    and the wavefront loop for any other."""
    if method == "auto":
        return "cuda" if device.type == "cuda" else "wavefront"
    if method not in ("wavefront", "cuda"):
        raise ValueError(f"unknown trace method {method!r}")
    if method == "cuda" and device.type != "cuda":
        raise ValueError(f"the trace kernel takes CUDA tensors; the volume "
                         f"is on {device}")
    return method


@torch.no_grad()
@telemetry.spanned("trace.photons")
def trace_photons(volume: Volume, tf: TransferFunction,
                  tf_scattering: TransferFunction,
                  light_samples: LightSamples, base_key: tuple,
                  config: TracerConfig, lane_ids: Tensor | None = None,
                  return_stats: bool = False, record_events: int = 0,
                  grids: tuple | None = None, method: str = "auto"):
    """Trace all light samples; returns a fresh PhotonData (radius fields
    default-initialized, the pipeline owns the progressive state).

    ``base_key`` is the (k0, k1) key. ``lane_ids`` (int64, (N,)) are the
    global photon ids whose random streams the lanes draw, ``arange(N)``
    by default: a retrace of a selected subset passes the original ids, so
    every photon keeps its stream. ``grids`` takes the result of
    :func:`majorant_grids` where one build serves several calls.
    ``method`` is "auto" (the kernel for CUDA tensors, the wavefront loop
    for CPU tensors), "cuda" (the kernel; CPU tensors raise) or
    "wavefront" (the plain version on any device).

    With ``return_stats`` the return is (photons, stats): ``wavefront_iters``
    (int, flights per lane slot, counted per flight), ``mean_active_frac``
    (() tensor, active lanes summed over flights / (max(iters, 1) * N)),
    ``active_history`` ((512,) int32 tensor, flight i's active count at
    min(i, 511)) and ``stage_widths`` ([N]: no stage ever narrows). The
    wavefront loop knows its flights on the host; the kernel's path reads
    them back once, the statistics' one host wait.

    With ``record_events=E`` (and no ``return_stats``, which takes
    precedence as in the reference) the return is (photons,
    :class:`TraceEvents`): each lane's first E tests, written where they
    happen without a host wait.
    """
    dev = volume.device
    method = _method(method, dev)
    n = light_samples.n
    if lane_ids is None:
        lane_ids = torch.arange(n, dtype=torch.int64, device=dev)
    elif lane_ids.shape != (n,):
        raise ValueError(f"lane_ids must be ({n},), got "
                         f"{tuple(lane_ids.shape)}")
    key = (int(base_key[0]), int(base_key[1]))
    with telemetry.span("trace.constants"):
        c = trace_constants(volume, tf, tf_scattering, config, grids,
                            method)
    run = _trace_kernel if method == "cuda" else _trace_wavefront
    (out_pos, out_pow, out_dir, exit_power, exit_dir), extra = run(
        c, volume, light_samples, key, lane_ids, return_stats, record_events)
    # Half storage (photon.cl:49-63): the FLT_MAX sentinel becomes +inf.
    dt = getattr(torch, config.photon_dtype)
    with telemetry.span("trace.outputs"):
        photons = PhotonData(
            positions=out_pos.to(dt).contiguous(),
            powers=out_pow.to(dt).contiguous(),
            directions=out_dir.to(dt).contiguous(),
            exit_power=exit_power, exit_direction=exit_dir,
            radius_rel=f32_scalar(config.radius_rel),
            scene_radius=f32_scalar(constants.DEFAULT_SCENE_RADIUS),
            iteration=0,
        )
    if return_stats or record_events:
        return photons, extra
    return photons


def _stats(iters: int, active_work: Tensor, active_hist: Tensor,
           n: int) -> dict:
    return {"wavefront_iters": iters,
            "mean_active_frac": active_work / float(max(iters, 1) * n),
            "active_history": active_hist, "stage_widths": [n]}


def _trace_kernel(c: TraceConstants, volume: Volume,
                  light_samples: LightSamples, key: tuple, lane_ids: Tensor,
                  return_stats: bool, record_events: int):
    """The trace as one launch of ``csrc/woodcock_trace.cu``: ((deposit
    positions, powers, directions, exit powers, exit directions), the
    statistics or the tape or None). A non-contiguous volume (a mixed
    playback step, a permuted view) is copied to a contiguous one."""
    ls = light_samples
    n = ls.n
    out = woodcock_trace.trace_woodcock_cuda(
        c, volume.data.contiguous(), ls.origins.contiguous(),
        ls.directions.contiguous(), ls.powers.contiguous(),
        ls.tspan.contiguous(), lane_ids.to(torch.int64).contiguous(), key,
        record_events=0 if return_stats else record_events,
        return_stats=return_stats)
    extra = None
    if return_stats:
        # The loop's exit test every K flights: K * ceil(L / K) flights,
        # L the most flights any lane was active for (the one host read).
        # The active lane-flights are the history's sum, which the
        # wavefront accumulates in float32: equal below 2^24.
        k = c.flights
        most = telemetry.wait("trace.stats", int, out.max_active[0])
        iters = k * -(-most // k)
        extra = _stats(iters, out.active_history.sum(dtype=torch.int64).to(
            torch.float32), out.active_history, n)
    elif record_events:
        extra = TraceEvents(positions=out.evt_pos, majorants=out.evt_maj,
                            types=out.evt_type, counts=out.n_evt)
    return out[:5], extra


@telemetry.spanned("trace.wavefront")
def _trace_wavefront(c: TraceConstants, volume: Volume,
                     light_samples: LightSamples, key: tuple,
                     lane_ids: Tensor, return_stats: bool,
                     record_events: int):
    """The plain version: every lane advances one flight per step, as
    torch operators over all N lanes; returns what :func:`_trace_kernel`
    returns."""
    dev = volume.device
    n = light_samples.n
    max_i = c.max_interactions
    k0, k1 = key

    maj, dist, maj_global = c.maj, c.dist, c.maj_global
    gz, gy, gx = maj.shape
    g_hi = torch.tensor([gx - 1, gy - 1, gz - 1], device=dev)
    maj_flat, dist_flat = maj.reshape(-1), dist.reshape(-1)

    sbi = c.sbi
    shape = c.shape
    cell_vox = c.cell_vox
    cell_ext = torch.tensor(c.cell_ext, dtype=torch.float32, device=dev)
    step_size = c.step_size
    cell_min_ext = c.cell_min_ext
    big = float(constants.FLT_MAX)
    ring = c.ring
    phase_g = c.phase_g

    def cell_of(p: Tensor) -> Tensor:
        return torch.floor(voxel_coords(shape, p)).to(torch.int64) // cell_vox

    def grid_at(cell: Tensor):
        cc = torch.minimum(cell, g_hi)
        idx = (cc[:, 2] * gy + cc[:, 1]) * gx + cc[:, 0]
        return maj_flat[idx], dist_flat[idx]

    t = light_samples.tspan[:, 0]
    t_end = light_samples.tspan[:, 1]
    clip_lo = torch.tensor(c.clip_min, dtype=torch.float32, device=dev)
    clip_hi = torch.tensor(c.clip_max, dtype=torch.float32, device=dev)
    if c.clipped:
        chit, ct0, ct1 = intersect.ray_box(
            light_samples.origins, light_samples.directions, clip_lo, clip_hi)
        t = torch.maximum(t, torch.where(chit, ct0, 0.0))
        t_end = torch.minimum(t_end, torch.where(chit, ct1, -1.0))

    pos = light_samples.origins
    dir_ = light_samples.directions
    power = light_samples.powers / float(max_i)
    n_int = torch.zeros(n, dtype=torch.int64, device=dev)
    active = t < t_end
    absorbed = torch.zeros(n, dtype=torch.bool, device=dev)
    nss = c.no_single_scattering
    if nss:
        # Lanes whose first collision is still to come scatter it
        # without a deposit.
        first_done = torch.zeros(n, dtype=torch.bool, device=dev)
    maj_carry = maj_global.expand(n)
    dist_carry = torch.zeros(n, dtype=torch.float32, device=dev)
    out_pos = torch.full((n, max_i, 3), big, dtype=torch.float32, device=dev)
    out_pow = torch.zeros((n, max_i, 3), dtype=torch.float32, device=dev)
    out_dir = torch.zeros((n, max_i, 2), dtype=torch.float32, device=dev)
    col_ids = torch.arange(max_i, device=dev)[None, :]  # (1, I)

    if return_stats:
        active_work = torch.zeros((), dtype=torch.float32, device=dev)
        active_hist = torch.zeros(_HISTORY, dtype=torch.int32, device=dev)
    counts = telemetry.device_counters(dev)
    if record_events:
        # Flat tape rows lane * E + e, and one row past them that takes
        # the writes of lanes that test nothing this flight.
        n_rows = n * record_events
        evt_pos = torch.zeros((n_rows + 1, 3), dtype=torch.float32,
                              device=dev)
        evt_maj = torch.zeros(n_rows + 1, dtype=torch.float32, device=dev)
        evt_type = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
        n_evt = torch.zeros(n, dtype=torch.int32, device=dev)
        row0 = torch.arange(n, device=dev) * record_events

    # The loop's condition, any(active) and step < max_steps, is tested
    # every K flights only: c.step_limit is max_steps rounded up to K.
    step = 0
    while step < c.step_limit and bool(active.any()):
        for _ in range(c.flights):
            if return_stats:
                n_active = active.sum(dtype=torch.int32)
                active_work += n_active
                active_hist.select(0, min(step, _HISTORY - 1)).add_(n_active)
            u = rng.uniforms(k0, k1, lane_ids, step, 5)
            # --- macrocell delta-tracking step ---
            p_cur = pos + t[:, None] * dir_
            maj_op = maj_carry
            t_cell = majorant_mod.block_exit_distance(
                pos, dir_, cell_of(p_cur), cell_ext, ring=ring)
            t_cell = torch.maximum(t_cell, t)

            dt = -torch.log(torch.clamp(u[:, 0], min=1e-12)) / torch.clamp(
                maj_op * sbi, min=1e-12)
            t_tent = t + dt
            # Null event: empty cell or a flight past the block exit. Empty
            # cells also jump (D-1) cells along the distance map.
            empty = maj_op <= 0.0
            skip = empty | (t_tent > t_cell)
            t_jump = t + torch.clamp(dist_carry - 1.0, min=0.0) * cell_min_ext
            t_clamp = torch.where(empty, torch.maximum(t_cell, t_jump),
                                  t_cell)
            t_new = torch.where(skip, t_clamp + _BOUNDARY_EPS, t_tent)
            exited = t_new > t_end

            p = pos + t_new[:, None] * dir_
            vol_sample = sample_volume_trilinear(volume.data, p)
            maj_at_p, dist_at_p = grid_at(cell_of(p))
            opacity = piecewise_opacity(c.tf_pos, c.tf_opa, vol_sample)
            # Acceptance against the local majorant: P = sigma / sigma_maj.
            accept = u[:, 1] * maj_op < opacity
            collide = active & ~exited & ~skip & accept
            if nss:
                first_event = collide & ~first_done
                interact = collide & first_done
            else:
                interact = collide

            # --- interaction (photontracer.cl:158-197) ---
            scat_w = piecewise_opacity(c.tfs_pos, c.tfs_opa,
                                       vol_sample)
            albedo = scat_w / torch.clamp(scat_w + opacity, min=1e-8)
            power_in = power / torch.clamp(opacity, min=0.01)[:, None]
            n_int_new = n_int + 1
            do_scatter = interact & (n_int_new < max_i) & (u[:, 2] < albedo)
            do_absorb = interact & ~do_scatter

            power_scat = power_in * albedo[:, None]
            stored_power = torch.where(do_scatter[:, None], power_scat,
                                       power_in)
            # Deposit at slot (lane, n_int); the stored direction is the
            # incoming one.
            slot = ((col_ids == n_int[:, None]) & interact[:, None])[..., None]
            out_pos = torch.where(slot, p[:, None, :], out_pos)
            out_pow = torch.where(slot, stored_power[:, None, :], out_pow)
            out_dir = torch.where(slot, encode_direction(dir_)[:, None, :],
                                  out_dir)
            if counts is not None:
                counts[0] += (active & ~exited & ~skip).sum()
                counts[1] += interact.sum()
            if record_events:
                # Every acceptance test, in the reference's priority
                # (tracer.py:447-464): rejected, first event, forced stop
                # at the cap, scatter, absorption.
                tested = active & ~exited & ~skip
                etype = torch.where(do_scatter, EVT_SCATTER, EVT_ABSORB)
                etype = torch.where(n_int_new >= max_i, EVT_FORCED, etype)
                if nss:
                    etype = torch.where(first_event, EVT_FIRST, etype)
                etype = torch.where(collide, etype, EVT_NULL)
                row = torch.where(tested & (n_evt < record_events),
                                  row0 + n_evt, n_rows)
                evt_pos[row] = p
                evt_maj[row] = maj_op
                evt_type[row] = etype.to(torch.int32)
                n_evt += tested

            # --- new direction for scattered photons ---
            new_dir, pdf = phase_mod.sample_phase(
                c.phase_type, dir_, phase_g, u[:, 3], u[:, 4])
            hit, bt0, bt1 = intersect.ray_box(p, new_dir, clip_lo, clip_hi)
            change_dir = do_scatter | first_event if nss else do_scatter
            still_active = active & ~exited & (~collide | (change_dir & hit))

            pos = torch.where(change_dir[:, None], p, pos)
            # Nudge past the interaction point (photontracer.cl:181-183).
            t = torch.where(change_dir, bt0 + 0.5 * step_size,
                            torch.where(interact, t, t_new))
            t_end = torch.where(change_dir, bt1, t_end)
            new_power = torch.where(
                interact[:, None],
                torch.where(do_scatter[:, None], power_scat, big), power)
            if nss:
                new_power = torch.where(
                    first_event[:, None],
                    power / torch.clamp(pdf, min=1e-8)[:, None], new_power)
                first_done = first_done | first_event
            dir_ = torch.where(change_dir[:, None], new_dir, dir_)
            power = new_power
            n_int = torch.where(interact, n_int_new, n_int)
            active = still_active
            absorbed = absorbed | do_absorb
            # After a direction change the next segment may start in
            # another cell: carry the global majorant for one step.
            maj_carry = torch.where(change_dir, maj_global, maj_at_p)
            dist_carry = torch.where(change_dir, 0.0, dist_at_p)
            step += 1

    deposits = (out_pos.transpose(0, 1), out_pow.transpose(0, 1),
                out_dir.transpose(0, 1),
                torch.where(absorbed, big, power[:, 0]),
                encode_direction(dir_))
    if return_stats:
        return deposits, _stats(step, active_work, active_hist, n)
    if record_events:
        shape = (n, record_events)
        return deposits, TraceEvents(
            positions=evt_pos[:n_rows].reshape(*shape, 3),
            majorants=evt_maj[:n_rows].reshape(shape),
            types=evt_type[:n_rows].reshape(shape), counts=n_evt)
    return deposits, None


@torch.no_grad()
@telemetry.spanned("trace.photons_chunked")
def trace_photons_chunked(volume: Volume, tf: TransferFunction,
                          tf_scattering: TransferFunction,
                          light_samples: LightSamples, base_key: tuple,
                          config: TracerConfig, chunk: int,
                          lane_ids: Tensor | None = None,
                          method: str = "auto") -> PhotonData:
    """Trace in sequential chunks of at most ``chunk`` lanes, which bounds
    the trace's temporaries; a last partial chunk is traced as a smaller
    one, each by ``method`` (see :func:`trace_photons`). Bit-identical to
    the trace in one piece: the random streams are keyed by global lane
    id, not by buffer position, and a lane that has ended no longer
    changes."""
    n = light_samples.n
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if chunk >= n:
        return trace_photons(volume, tf, tf_scattering, light_samples,
                             base_key, config, lane_ids=lane_ids,
                             method=method)
    grids = majorant_grids(volume, tf, config, method)
    outs = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        sub = LightSamples(
            origins=light_samples.origins[lo:hi],
            directions=light_samples.directions[lo:hi],
            powers=light_samples.powers[lo:hi],
            tspan=light_samples.tspan[lo:hi],
            iteration=light_samples.iteration)
        ids = (lane_ids[lo:hi] if lane_ids is not None else
               torch.arange(lo, hi, dtype=torch.int64, device=volume.device))
        outs.append(trace_photons(volume, tf, tf_scattering, sub, base_key,
                                  config, lane_ids=ids, grids=grids,
                                  method=method))
    return dataclasses.replace(
        outs[0],
        positions=torch.cat([o.positions for o in outs], dim=1),
        powers=torch.cat([o.powers for o in outs], dim=1),
        directions=torch.cat([o.directions for o in outs], dim=1),
        exit_power=torch.cat([o.exit_power for o in outs]),
        exit_direction=torch.cat([o.exit_direction for o in outs]))


@telemetry.spanned("pipeline.merge_recomputed")
def merge_recomputed(photons: PhotonData, new: PhotonData, indices: Tensor,
                     valid: Tensor) -> PhotonData:
    """Copy the retraced subset back into the full photon buffer: ``new``
    holds B retraced photons whose global ids are ``indices``; lanes with
    ``valid == False`` (budget padding) write nothing. Returns a new
    PhotonData; ``photons`` is left as it was."""
    # The one place whose shape depends on the data: the valid lanes'
    # numbers (one read of their count by the host on a CUDA device).
    lanes = telemetry.wait("trace.merge_lanes", torch.nonzero, valid)[:, 0]
    idx = indices.to(torch.int64)[lanes]

    def put(old: Tensor, fresh: Tensor, dim: int) -> Tensor:
        fresh = fresh.index_select(dim, lanes).to(old.dtype)
        return old.clone().index_copy_(dim, idx, fresh)

    return dataclasses.replace(
        photons,
        positions=put(photons.positions, new.positions, 1),
        powers=put(photons.powers, new.powers, 1),
        directions=put(photons.directions, new.directions, 1),
        exit_power=put(photons.exit_power, new.exit_power, 0),
        exit_direction=put(photons.exit_direction, new.exit_direction, 0))

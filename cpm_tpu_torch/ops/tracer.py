"""Wavefront photon tracer: Woodcock (delta) tracking through a
TF-classified volume with scattering, absorption and per-interaction
photon deposition (``cpm_tpu/ops/tracer.py:trace_photons``, :253-601),
its chunked form (:604-647) and the merge of a retraced subset back into
the photon buffer (:650-692).

All lanes advance together, one tentative flight per lane per wavefront
step, with the reference's per-lane state machine (:348-497) unchanged:
macrocell majorants, flights clamped at the exit of the (2*ring+1)^3
block of cells, capped empty-space jumps, (lane, global step)-keyed
threefry draws, and ``flights_per_iteration`` steps between two checks
of the loop condition ``any(active) and step < max_steps``.

The reference's packed brick table and staged lane compaction exist only
for TPU gathers and leave the trajectories unchanged, so they are left
out: the volume is sampled with direct trilinear gathers, and the
majorant and skip distance a lane carries are read at the same voxel
quantization as the brick column, ``grid[floor(clip(p*dim - 0.5)) //
cell_size]``.

Options (``TracerConfig``): ``no_single_scattering`` turns each lane's
first collision into a scatter without a deposit (power divided by the
phase pdf, no albedo test), so only multiple scattering is stored;
``photon_dtype="float16"`` casts the three deposit fields at the end (the
trace itself runs in float32; FLT_MAX becomes +inf, which every
consumer's ``< 1e30`` test still reads as unused). ``return_stats`` adds
the wavefront counters; ``record_events=E`` adds the event tape of the
trajectory gradients (:class:`TraceEvents`, read by ``ops/score_grad.py``).

The trace records no autograd graph (it runs under ``torch.no_grad``):
its sampling decisions are discrete, and ``ops/replay.py`` recomputes the
powers differentiably from what it stored.
"""

from __future__ import annotations

import dataclasses

import torch

from typing import NamedTuple

from cpm_tpu_torch.core import constants
from cpm_tpu_torch.core.config import TracerConfig
from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      TransferFunction, Volume,
                                      encode_direction, f32_scalar)
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


def majorant_grids(volume: Volume, tf: TransferFunction,
                   config: TracerConfig):
    """(maj, dist, maj_global, cell_min_ext): per-cell majorant opacity
    (times tau_max), the capped empty-space distance map, their global max
    and the texture extent of one skippable cell (tracer.py:164-176)."""
    if config.use_majorant_grid:
        maj = majorant_mod.build_majorant_grid(
            volume, tf, config.majorant_cell_size, config.block_ring)
    else:
        maj = torch.ones((1, 1, 1), dtype=torch.float32,
                         device=volume.device)
    maj = maj * f32_scalar(config.tau_max)
    dist = majorant_mod.empty_distance_grid(maj, cap=config.empty_jump_cap)
    cell_min_ext = f32_scalar(1.0 / max(maj.shape))
    return maj, dist, torch.amax(maj), cell_min_ext


@torch.no_grad()
def trace_photons(volume: Volume, tf: TransferFunction,
                  tf_scattering: TransferFunction,
                  light_samples: LightSamples, base_key: tuple,
                  config: TracerConfig, lane_ids: Tensor | None = None,
                  return_stats: bool = False, record_events: int = 0,
                  grids: tuple | None = None):
    """Trace all light samples; returns a fresh PhotonData (radius fields
    default-initialized, the pipeline owns the progressive state).

    ``base_key`` is the (k0, k1) key. ``lane_ids`` (int64, (N,)) are the
    global photon ids whose random streams the lanes draw, ``arange(N)``
    by default: a retrace of a selected subset passes the original ids, so
    every photon keeps its stream. ``grids`` takes the result of
    :func:`majorant_grids` where one build serves several calls.

    With ``return_stats`` the return is (photons, stats): ``wavefront_iters``
    (int, flights per lane slot, counted per flight), ``mean_active_frac``
    (() tensor, active lanes summed over flights / (max(iters, 1) * N)),
    ``active_history`` ((512,) int32 tensor, flight i's active count at
    min(i, 511)) and ``stage_widths`` ([N]: this loop never compacts).
    The counters stay on the device; collecting them adds no host wait.

    With ``record_events=E`` (and no ``return_stats``, which takes
    precedence as in the reference) the return is (photons,
    :class:`TraceEvents`): each lane's first E tests, written where they
    happen without a host wait.
    """
    dev = volume.device
    n = light_samples.n
    max_i = config.max_interactions
    if lane_ids is None:
        lane_ids = torch.arange(n, dtype=torch.int64, device=dev)
    elif lane_ids.shape != (n,):
        raise ValueError(f"lane_ids must be ({n},), got "
                         f"{tuple(lane_ids.shape)}")
    k0, k1 = int(base_key[0]), int(base_key[1])

    if grids is None:
        grids = majorant_grids(volume, tf, config)
    maj, dist, maj_global, cell_min_ext = grids
    gz, gy, gx = maj.shape
    g_hi = torch.tensor([gx - 1, gy - 1, gz - 1], device=dev)
    maj_flat, dist_flat = maj.reshape(-1), dist.reshape(-1)

    sbi = f32_scalar(constants.SAMPLING_BASE_INTERVAL_RCP)
    shape = volume.shape_zyx
    d_, h_, w_ = shape
    vdims = torch.tensor([w_, h_, d_], dtype=torch.float32, device=dev)
    cell_vox = config.majorant_cell_size
    cell_ext = float(cell_vox) / vdims  # cell extent, texture units
    step_size = f32_scalar(1.0 / (config.sampling_rate * max(shape)))
    big = float(constants.FLT_MAX)
    ring = config.block_ring
    phase_g = f32_scalar(config.phase_g)

    def cell_of(p: Tensor) -> Tensor:
        return torch.floor(voxel_coords(shape, p)).to(torch.int64) // cell_vox

    def grid_at(cell: Tensor):
        c = torch.minimum(cell, g_hi)
        idx = (c[:, 2] * gy + c[:, 1]) * gx + c[:, 0]
        return maj_flat[idx], dist_flat[idx]

    t = light_samples.tspan[:, 0]
    t_end = light_samples.tspan[:, 1]
    clip_lo = torch.tensor(config.clip_min, dtype=torch.float32, device=dev)
    clip_hi = torch.tensor(config.clip_max, dtype=torch.float32, device=dev)
    if config.clip_min != (0.0, 0.0, 0.0) or \
            config.clip_max != (1.0, 1.0, 1.0):
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
    nss = config.no_single_scattering
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

    step = 0
    k_unroll = max(1, config.flights_per_iteration)
    while step < config.max_steps and bool(active.any()):
        for _ in range(k_unroll):
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
            opacity = tf.sample_opacity(vol_sample)
            # Acceptance against the local majorant: P = sigma / sigma_maj.
            accept = u[:, 1] * maj_op < opacity
            collide = active & ~exited & ~skip & accept
            if nss:
                first_event = collide & ~first_done
                interact = collide & first_done
            else:
                interact = collide

            # --- interaction (photontracer.cl:158-197) ---
            scat_w = tf_scattering.sample_opacity(vol_sample)
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
                config.phase_type, dir_, phase_g, u[:, 3], u[:, 4])
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

    # Half storage (photon.cl:49-63): the FLT_MAX sentinel becomes +inf.
    dt = getattr(torch, config.photon_dtype)
    photons = PhotonData(
        positions=out_pos.transpose(0, 1).to(dt).contiguous(),
        powers=out_pow.transpose(0, 1).to(dt).contiguous(),
        directions=out_dir.transpose(0, 1).to(dt).contiguous(),
        exit_power=torch.where(absorbed, big, power[:, 0]),
        exit_direction=encode_direction(dir_),
        radius_rel=f32_scalar(config.radius_rel),
        scene_radius=f32_scalar(constants.DEFAULT_SCENE_RADIUS),
        iteration=0,
    )
    if return_stats:
        return photons, {
            "wavefront_iters": step,
            "mean_active_frac": active_work / float(max(step, 1) * n),
            "active_history": active_hist,
            "stage_widths": [n],
        }
    if record_events:
        shape = (n, record_events)
        return photons, TraceEvents(
            positions=evt_pos[:n_rows].reshape(*shape, 3),
            majorants=evt_maj[:n_rows].reshape(shape),
            types=evt_type[:n_rows].reshape(shape), counts=n_evt)
    return photons


@torch.no_grad()
def trace_photons_chunked(volume: Volume, tf: TransferFunction,
                          tf_scattering: TransferFunction,
                          light_samples: LightSamples, base_key: tuple,
                          config: TracerConfig, chunk: int,
                          lane_ids: Tensor | None = None) -> PhotonData:
    """Trace in sequential chunks of at most ``chunk`` lanes, which bounds
    the wavefront's temporaries; a last partial chunk is traced as a
    smaller one. Bit-identical to the trace in one piece: the random
    streams are keyed by global lane id, not by buffer position, and a lane
    that has ended no longer changes."""
    n = light_samples.n
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if chunk >= n:
        return trace_photons(volume, tf, tf_scattering, light_samples,
                             base_key, config, lane_ids=lane_ids)
    grids = majorant_grids(volume, tf, config)
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
                                  config, lane_ids=ids, grids=grids))
    return dataclasses.replace(
        outs[0],
        positions=torch.cat([o.positions for o in outs], dim=1),
        powers=torch.cat([o.powers for o in outs], dim=1),
        directions=torch.cat([o.directions for o in outs], dim=1),
        exit_power=torch.cat([o.exit_power for o in outs]),
        exit_direction=torch.cat([o.exit_direction for o in outs]))


def merge_recomputed(photons: PhotonData, new: PhotonData, indices: Tensor,
                     valid: Tensor) -> PhotonData:
    """Copy the retraced subset back into the full photon buffer: ``new``
    holds B retraced photons whose global ids are ``indices``; lanes with
    ``valid == False`` (budget padding) write nothing. Returns a new
    PhotonData; ``photons`` is left as it was."""
    # The one place whose shape depends on the data: the valid lanes'
    # numbers (one read of their count by the host on a CUDA device).
    lanes = torch.nonzero(valid)[:, 0]
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

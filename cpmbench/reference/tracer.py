"""The trace's plain form, frozen: Woodcock (delta) tracking through a
TF-classified volume with scattering, absorption and per-interaction photon
deposition, one flight of every lane per step as torch operators, with
macrocell majorants, flights clamped at the exit of the (2*ring+1)^3 block
of cells, capped empty-space jumps and (lane, step)-keyed threefry draws;
``flights_per_iteration`` (K) flights between two tests of the loop
condition ``any(active) and step < max_steps``. It also merges a retraced
subset back into a photon buffer.

With ``counts=True`` the trace also returns what it did, which the
benchmark's trace roofline counts work by: the active lane-flights, the
flights that made an acceptance test, and the interactions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cpmbench.reference import constants
from cpmbench.reference.config import TracerConfig
from cpmbench.reference.types import (LightSamples, PhotonData,
                                      TransferFunction, Volume,
                                      encode_direction, f32_scalar,
                                      piecewise_opacity)
from cpmbench.reference import intersect, majorant as majorant_mod, rng
from cpmbench.reference import phase as phase_mod
from cpmbench.reference.sampling import sample_volume_trilinear, voxel_coords

Tensor = torch.Tensor

# Nudge past a macrocell boundary: large vs float32 ulp at ~1.0, small vs
# a voxel.
_BOUNDARY_EPS = 1e-5


def _cell_min_ext(maj: Tensor) -> float:
    return float(np.float32(1.0) / np.float32(max(maj.shape)))


def majorant_grids(volume: Volume, tf: TransferFunction,
                         config: TracerConfig):
    """(maj, dist, maj_global, cell_min_ext): per-cell majorant opacity
    (times tau_max), the capped empty-space distance map, their global max
    and the texture extent of one skippable cell."""
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
    device."""

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
    maj: Tensor  # (gz, gy, gx) majorants 
    dist: Tensor  # (gz, gy, gx) empty-space distances, in cells
    maj_global: Tensor  # () their max, never read by the host
    max_interactions: int
    no_single_scattering: bool
    flights: int  # K, flights between two tests of the loop condition
    step_limit: int  # K * ceil(max_steps / K): no lane flies further


def trace_constants(volume: Volume, tf: TransferFunction,
                    tf_scattering: TransferFunction,
                    config: TracerConfig) -> TraceConstants:
    """The constants of one trace of ``volume`` under ``config``, numbers
    rounded as float32 arithmetic rounds them."""
    maj, dist, maj_global, cell_min_ext = majorant_grids(volume, tf, config)
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


@torch.no_grad()
def trace_photons(volume: Volume, tf: TransferFunction,
                  tf_scattering: TransferFunction,
                  light_samples: LightSamples, base_key: tuple,
                  config: TracerConfig, lane_ids: Tensor | None = None,
                  counts: bool = False):
    """Trace all light samples; returns a fresh PhotonData (radius fields
    default-initialized), and with ``counts`` also a dict of the trace's
    work (``lane_flights``, ``tests``, ``interactions``: Python ints).
    ``lane_ids`` (int64, (N,)) are the global photon ids whose random
    streams the lanes draw, ``arange(N)`` by default."""
    dev = volume.device
    n = light_samples.n
    if lane_ids is None:
        lane_ids = torch.arange(n, dtype=torch.int64, device=dev)
    key = (int(base_key[0]), int(base_key[1]))
    c = trace_constants(volume, tf, tf_scattering, config)
    (out_pos, out_pow, out_dir, exit_power, exit_dir), work = _trace_wavefront(
        c, volume, light_samples, key, lane_ids)
    photons = PhotonData(
        positions=out_pos.contiguous(), powers=out_pow.contiguous(),
        directions=out_dir.contiguous(),
        exit_power=exit_power, exit_direction=exit_dir,
        radius_rel=f32_scalar(config.radius_rel),
        scene_radius=f32_scalar(constants.DEFAULT_SCENE_RADIUS),
        iteration=0,
    )
    if counts:
        return photons, {k: int(v) for k, v in work.items()}
    return photons


def _trace_wavefront(c: TraceConstants, volume: Volume,
                     light_samples: LightSamples, key: tuple,
                     lane_ids: Tensor):
    """Every lane advances one flight per step, as torch operators over all
    N lanes: ((deposit positions, powers, directions, exit powers, exit
    directions), the work counts as 0-dim int64 tensors)."""
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
    lane_flights, tests, interactions = (
        torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3))

    # The loop's condition, any(active) and step < max_steps, is tested
    # every K flights only: c.step_limit is max_steps rounded up to K.
    step = 0
    while step < c.step_limit and bool(active.any()):
        for _ in range(c.flights):
            lane_flights += active.sum()
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
            tested = active & ~exited & ~skip
            collide = tested & accept
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
            tests += tested.sum()
            interactions += interact.sum()

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
    return deposits, {"lane_flights": lane_flights, "tests": tests,
                      "interactions": interactions}


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

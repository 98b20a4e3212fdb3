"""Photon-path recomputation importance: integrate the importance grid
along each photon's stored path (``cpm_tpu/ops/path_importance.py``).

Three integrators over per-segment endpoints in voxel coordinates: the
exact 3D-DDA traversal (Amanatides-Woo, a fixed number of steps with
active masks over all (lane, segment) pairs at once) and the K-sample
midpoint quadrature, whose lookups are plain gathers. The reference's
third mode, ``"quadrature_mxu"`` (the configuration's default), recasts
each of those lookups as a one-hot matrix product because gathers are slow
on a TPU; every output of that product has exactly one nonzero term, so
its values are the gather quadrature's. Here the mode name selects the
gather quadrature, and no one-hot form exists.

A never-interacting photon's segment ends at ``origin + tEnd *
direction``, as the reference has it. Float16 photons are widened to
float32 before the sentinel test; the reference tests them in float16,
where ``+inf > 1e30`` is false, so there an unused slot reads as a deposit
at infinity and the photon's importance becomes inf or NaN.
"""

from __future__ import annotations

import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.device import resolve
from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      UniformGrid3D, decode_direction)
from cpm_tpu_torch.ops import intersect

Tensor = torch.Tensor

MODES = ("dda", "quadrature", "quadrature_mxu")


def grid_segment_integral(grid: Tensor, x1: Tensor, x2: Tensor,
                          cell_dim: Tensor, max_steps: int = 96) -> Tensor:
    """Integral of per-cell grid values along segments, exact DDA.

    ``grid`` is (gz, gy, gx) cell values, ``x1``/``x2`` (M, 3) endpoints in
    volume voxel coordinates (x, y, z), ``cell_dim`` (3,) the cell size in
    voxels, ``max_steps`` the trip count (>= gx + gy + gz for exactness).
    Returns (M,): the sum over visited cells of value * (t-coverage),
    scaled by |x2 - x1|.
    """
    gz, gy, gx = grid.shape
    dev = grid.device
    max_cells = torch.tensor([gx, gy, gz], dtype=torch.int64, device=dev)
    m = x1.shape[0]
    flat = grid.reshape(-1)

    # floor for the start cell, a truncating cast for the end cell.
    cellf = torch.clamp(torch.floor(x1 / cell_dim),
                        min=torch.zeros(3, device=dev),
                        max=(max_cells - 1).to(torch.float32))
    cell = cellf.to(torch.int64)
    cell_end = torch.clamp((x2 / cell_dim).to(torch.int64),
                           min=torch.zeros_like(max_cells), max=max_cells - 1)
    di = torch.sign(x2 - x1).to(torch.int64)
    inv_abs = 1.0 / torch.clamp(torch.abs(x2 - x1), min=1e-30)
    minx = cell_dim * cellf
    maxx = minx + cell_dim
    dt = torch.where(x1 > x2, x1 - minx, maxx - x1) * inv_abs
    deltat = cell_dim * inv_abs

    acc = torch.zeros(m, dtype=torch.float32, device=dev)
    dt1_prev = torch.zeros(m, dtype=torch.float32, device=dev)
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        val = flat[(cell[:, 2] * gy + cell[:, 1]) * gx + cell[:, 0]]
        # Step to the next cell boundary; ties go to x, then y, then z.
        ax = (dt[:, 0] <= dt[:, 1]) & (dt[:, 0] <= dt[:, 2])
        ay = ~ax & (dt[:, 1] <= dt[:, 2])
        az = ~ax & ~ay
        advance = torch.stack([ax, ay, az], dim=-1)
        t_hit = torch.where(ax, dt[:, 0], torch.where(ay, dt[:, 1], dt[:, 2]))
        at_end = (advance & (cell == cell_end)).any(dim=-1)
        cont = alive & ~at_end
        acc = acc + torch.where(
            alive, val * (torch.clamp(t_hit, max=1.0) - dt1_prev), 0.0)
        move = advance & cont[:, None]
        dt = torch.where(move, dt + deltat, dt)
        cell = torch.where(move, cell + di, cell)
        dt1_prev = torch.where(cont, t_hit, dt1_prev)
        alive = cont
    return acc * torch.linalg.vector_norm(x2 - x1, dim=-1)


def grid_segment_integral_quadrature(grid: Tensor, x1: Tensor, x2: Tensor,
                                     cell_dim: Tensor,
                                     n_samples: int = 8) -> Tensor:
    """Midpoint-quadrature approximation of :func:`grid_segment_integral`:
    the mean of the grid at ``n_samples`` midpoints times |x2 - x1|. The
    importance only feeds a ranking; cells thinner than |segment| / K can
    be missed, so use the DDA where exact drain coverage matters more."""
    gz, gy, gx = grid.shape
    dev = grid.device
    hi = telemetry.wait("path_importance.grid_hi", torch.tensor,
                        [gx - 1, gy - 1, gz - 1], dtype=torch.float32,
                        device=dev)
    ts = (torch.arange(n_samples, dtype=torch.float32, device=dev)
          + 0.5) / n_samples
    # (K, M, 3) sample points in voxel coordinates -> cell indices
    p = x1[None, :, :] + ts[:, None, None] * (x2 - x1)[None, :, :]
    c = torch.clamp(torch.floor(p / cell_dim),
                    min=torch.zeros(3, device=dev), max=hi).to(torch.int64)
    vals = grid.reshape(-1)[(c[..., 2] * gy + c[..., 1]) * gx + c[..., 0]]
    return vals.mean(dim=0) * torch.linalg.vector_norm(x2 - x1, dim=-1)


def photon_path_importance(importance_grid: UniformGrid3D,
                           photons: PhotonData, light_samples: LightSamples,
                           max_steps: int = 96, mode: str = "dda",
                           n_samples: int = 8) -> Tensor:
    """Per-light-sample recomputation importance, (N,) float32 (higher =
    recompute first): each stored interaction segment, entry to exit, is
    integrated through the importance grid. Absorbed paths stop at their
    last photon; paths that left the volume extend along the stored exit
    direction to the box."""
    if mode not in MODES:
        raise ValueError(f"unknown importance mode {mode!r}")
    i_max, n, _ = photons.positions.shape
    grid = importance_grid.data
    cell_dim = importance_grid.cell_dim
    vol_dim = importance_grid.volume_dim  # (3,) voxels (x, y, z)
    big = 1e30

    t0 = light_samples.tspan[:, 0]
    t1 = light_samples.tspan[:, 1]
    entry = light_samples.origins + t0[:, None] * light_samples.directions
    exit_dir = decode_direction(photons.exit_direction)
    absorbed = photons.exit_power > big

    entries, exits, seg_valid = [], [], []
    alive = t0 < t1
    # Float16 photons are widened first: in float16 the 1e30 sentinel test
    # below would compare against +inf and read every unused slot as a
    # deposit, and torch keeps float16 where it meets a float32 scalar.
    positions = photons.positions.to(torch.float32)
    for i in range(i_max):
        pos_i = positions[i]  # (N, 3)
        is_sentinel = pos_i[:, 0] > big
        if i == 0:
            # Never interacted: the segment spans the whole ray.
            exit_plain = (light_samples.origins
                          + t1[:, None] * light_samples.directions)
            sentinel_ok = is_sentinel
        else:
            # Left after >= 1 scatters: extend along the stored exit
            # direction to the box boundary; absorbed paths stop.
            hit, _, bt1 = intersect.ray_box(entry, exit_dir)
            exit_plain = entry + bt1[:, None] * exit_dir
            sentinel_ok = is_sentinel & ~absorbed & hit
        entries.append(entry)
        exits.append(torch.where(is_sentinel[:, None], exit_plain, pos_i))
        seg_valid.append(alive & (~is_sentinel | sentinel_ok))
        alive = alive & ~is_sentinel  # a path continues only via real photons
        entry = pos_i

    sv = torch.cat(seg_valid)
    # Texture -> voxel coordinates; unused segments collapse to x1 = x2 = 0,
    # which integrates to 0.
    x1 = torch.where(sv[:, None], torch.cat(entries) * vol_dim, 0.0)
    x2 = torch.where(sv[:, None], torch.cat(exits) * vol_dim, 0.0)
    if mode == "dda":
        seg_imp = grid_segment_integral(grid, x1, x2, cell_dim, max_steps)
    else:
        seg_imp = grid_segment_integral_quadrature(grid, x1, x2, cell_dim,
                                                   n_samples)
    seg_imp = torch.where(sv, seg_imp, 0.0)
    return seg_imp.reshape(i_max, n).sum(dim=0)


def equal_importance(n: int, iteration: int, percentage: int,
                     device=None) -> Tensor:
    """Round-robin pseudo-importance: 1 for every (100 // percentage)-th
    photon, shifted by ``iteration``; on the card unless ``device`` names
    another."""
    period = max(100 // percentage, 1)
    ids = torch.arange(n, dtype=torch.int64, device=resolve(device))
    return torch.where((ids + int(iteration)) % period == 0, 1.0, 0.0)

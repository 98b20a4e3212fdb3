"""Time-varying playback in plain float32 torch: the sequence's analysis,
the volume at a fractional time and one step of playback, written against
the frozen forms in this folder and nothing of the program.

Upstream (the inviwo modules the paper's system builds on):
``VolumeSequencePlayer`` mixes the two volumes that bracket the playback
time (``glsl/volume_mix.frag``: ``mix(vol_t, vol_{t+1}, frac)``);
``DynamicVolumeDifferenceAnalysis`` keeps, per cell and time-step pair
(t, t+1), the mean absolute voxel difference over the data range; the
time-varying classification weighs the TF's importance over the min/max
envelope of both steps by that difference, and the recomputation detector
ranks photon paths by it.

Departures from that description, each the port's own:

- Time is cyclic: step T - 1 pairs with step 0, in the mix and in the
  difference grids (the player's wrap-around timer; upstream's analysis
  stops at the last pair).
- Cells start at voxel 0 and the last cell along an axis may be partial,
  its mean over its real voxels (the JAX package pools with "SAME"
  padding, which shifts the cells where a side is not a multiple of the
  cell size; at multiples the two agree).
- The mean of a cell is its voxels summed in z, y, x order and divided by
  their count, as a per-cell loop sums them.
- A step of playback is one correlated batch of a fresh drain round
  (:func:`cpmbench.reference.pipeline.correlated_update`): the
  importance-ranked retrace and the removed and added splats. The program
  splats the signed list of both at once (``correlated_step``), which
  rounds otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from cpmbench.reference import importance, minmax
from cpmbench.reference import pipeline as P
from cpmbench.reference.types import UniformGrid3D

Tensor = torch.Tensor


@dataclass
class Sequence:
    """A sequence and its analysis: ``volumes`` (T, D, H, W), ``minmax``
    (T, gz, gy, gx, 2) and ``diff`` (T, gz, gy, gx), cells of
    ``cell_size`` voxels."""

    volumes: Tensor
    minmax: Tensor
    diff: Tensor
    cell_size: int

    @property
    def n_steps(self) -> int:
        return self.volumes.shape[0]


def mix(a: Tensor, b: Tensor, x: float) -> Tensor:
    """a * (1 - x) + b * x in float32, ``x`` rounded to float32."""
    xf = np.float32(x)
    return a * float(np.float32(1.0) - xf) + b * float(xf)


def floor_step(time: float, n_steps: int) -> int:
    """The step at or below ``time`` (float32), modulo ``n_steps``."""
    return math.floor(np.float32(time)) % n_steps


def sequence_sample(volumes: Tensor, time: float) -> Tensor:
    """The (T, ...) sequence at fractional ``time``: steps floor(time) mod
    T and the next one mod T, mixed by the fraction; at an integer time
    the step itself."""
    tf = np.float32(time)
    i0 = floor_step(time, volumes.shape[0])
    return mix(volumes[i0], volumes[(i0 + 1) % volumes.shape[0]],
               tf - np.float32(math.floor(tf)))


def difference_grids(volumes: Tensor, cell_size: int = 8,
                     data_range: float = 1.0) -> Tensor:
    """(T, D, H, W) -> (T, gz, gy, gx), gz = ceil(D / cell_size): grid t
    holds each cell's mean of |v_{(t+1) mod T} - v_t| / data_range over
    the cell's voxels."""
    t, d, h, w = volumes.shape
    c = cell_size
    g = [-(-n // c) for n in (d, h, w)]
    diff = torch.abs(torch.roll(volumes, -1, 0) - volumes) / data_range
    # Zeros past the volume's edge: adding one leaves a sum as it was.
    padded = diff.new_zeros((t, g[0] * c, g[1] * c, g[2] * c))
    padded[:, :d, :h, :w] = diff
    total = padded.new_zeros((t, *g))
    for z in range(c):
        for y in range(c):
            for x in range(c):
                total += padded[:, z::c, y::c, x::c]
    counts = [torch.clamp(n - c * torch.arange(k, device=volumes.device),
                          max=c) for n, k in zip((d, h, w), g)]
    voxels = (counts[0][:, None, None] * counts[1][None, :, None]
              * counts[2][None, None, :]).to(torch.float32)
    return total / voxels


def prepare(volumes: Tensor, cell_size: int = 8,
            data_range: float = 1.0) -> Sequence:
    """The analysis of the (T, D, H, W) float32 sequence."""
    return Sequence(volumes=volumes,
                    minmax=minmax.sequence_min_max(volumes, cell_size),
                    diff=difference_grids(volumes, cell_size, data_range),
                    cell_size=cell_size)


def time_varying_importance(seq: Sequence, time: float, positions: Tensor,
                            colors: Tensor, weights: tuple
                            ) -> UniformGrid3D:
    """The importance grid of playback at ``time``: the floor step's
    difference grid times the TF's importance over the min/max envelope
    of the floor step and the next."""
    i0 = floor_step(time, seq.n_steps)
    i1 = (i0 + 1) % seq.n_steps
    a, b = seq.minmax[i0], seq.minmax[i1]
    env = torch.stack([torch.minimum(a[..., 0], b[..., 0]),
                       torch.maximum(a[..., 1], b[..., 1])], dim=-1)
    imp = seq.diff[i0] * importance.classify_importance(env, positions,
                                                        colors, weights)
    d, h, w = seq.volumes.shape[1:]
    dev = imp.device
    return UniformGrid3D(
        data=imp,
        cell_dim=torch.full((3,), float(seq.cell_size), device=dev),
        volume_dim=torch.tensor([w, h, d], dtype=torch.float32, device=dev))


def advance_time(scene: P.Scene, samples, key: tuple, config, photons,
                 light_volume: Tensor, seq: Sequence, time: float,
                 p: P.Precision = P.EXACT):
    """One step of playback to ``time`` from ``photons`` and
    ``light_volume``: the scene with the mixed volume, and
    :func:`cpmbench.reference.pipeline.correlated_update`'s result for a
    fresh drain round under the time-varying importance grid (default
    weights) with the configured budget."""
    scene = dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, data=sequence_sample(seq.volumes, time)))
    grid = time_varying_importance(
        seq, time, scene.tf.positions, scene.tf.colors,
        importance.ImportanceWeights().normalized())
    retraced = torch.zeros(samples.n, dtype=torch.bool,
                           device=light_volume.device)
    budget = P.recompute_budget(config, samples.n)
    return scene, P.correlated_update(scene, samples, key, config, photons,
                                      light_volume, retraced, grid, budget,
                                      p=p)

"""Time-varying volume playback with correlated selective recomputation
(``cpm_tpu/pipeline/timevarying.py``).

The analysis of the whole sequence (min/max grids and difference grids of
every step) runs once, batched over the steps, in
:meth:`VolumeSequence.prepare`. A time step is one :func:`advance_time`:
interpolate the volume, build the time-varying importance grid, and run
the correlated update (or a full retrace).

Playback is traced by the recorder (``core/telemetry.py``): the spans
``playback.prepare``, ``playback.advance_time`` and, inside it,
``playback.mix`` and ``playback.importance``; its host waits go through
``telemetry.wait`` (sites ``playback.*``); the host counters
``playback.frames`` (one an :func:`advance_time`) and
``playback.new_step`` (the frames whose floor step differs from the
previous frame's) count always.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.config import PipelineConfig
from cpm_tpu_torch.core.device import resolve
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import UniformGrid3D
from cpm_tpu_torch.ops import diffanalysis, minmax, mixer
from cpm_tpu_torch.ops import importance as importance_mod
from cpm_tpu_torch.pipeline import step as pstep
from cpm_tpu_torch.pipeline.state import PhotonMapState

Tensor = torch.Tensor


@dataclass
class VolumeSequence:
    """A preprocessed time-varying dataset: the volume sequence and the
    per-step analysis grids the correlated updates need."""

    volumes: Tensor  # (T, D, H, W) float32 in [0, 1]
    minmax: Tensor  # (T, gz, gy, gx, 2)
    diff: Tensor  # (T, gz, gy, gx) mean |v_{t+1} - v_t| per cell
    cell_size: int = 8

    @property
    def n_steps(self) -> int:
        return self.volumes.shape[0]

    @classmethod
    @telemetry.spanned("playback.prepare")
    def prepare(cls, volumes, cell_size: int = 8, data_range: float = 1.0,
                device=None) -> "VolumeSequence":
        """Run the sequence analysis, on the card unless ``device`` names
        another."""
        volumes = telemetry.wait(
            "playback.sequence", torch.as_tensor, volumes,
            dtype=torch.float32, device=resolve(device)).contiguous()
        return cls(volumes=volumes,
                   minmax=minmax.sequence_min_max(volumes, cell_size),
                   diff=diffanalysis.volume_difference_grids(
                       volumes, cell_size, data_range),
                   cell_size=cell_size)


def floor_step(time: float, n_steps: int) -> int:
    """The sequence step at or below fractional ``time`` (cyclic)."""
    return math.floor(np.float32(time)) % n_steps


@telemetry.spanned("playback.importance")
def time_step_importance(seq_minmax: Tensor, seq_diff: Tensor, time: float,
                         tf_positions: Tensor, tf_colors: Tensor,
                         volume_dim: tuple, cell_size: int,
                         weights: tuple) -> UniformGrid3D:
    """Importance grid for advancing playback to fractional ``time``: the
    floor step's difference grid times the TF importance over the min/max
    envelope of the two bracketing steps."""
    t = seq_minmax.shape[0]
    i0 = floor_step(time, t)
    i1 = (i0 + 1) % t
    imp = importance_mod.classify_time_varying_importance(
        seq_minmax[i0], seq_minmax[i1], seq_diff[i0], tf_positions,
        tf_colors, weights)
    d, h, w = volume_dim
    dev = imp.device
    return UniformGrid3D(
        data=imp, cell_dim=torch.full((3,), float(cell_size), device=dev),
        volume_dim=telemetry.wait("playback.volume_dim", torch.tensor,
                                  [w, h, d], dtype=torch.float32,
                                  device=dev))


@telemetry.spanned("playback.advance_time")
def advance_time(scene: Scene, state: PhotonMapState, seq: VolumeSequence,
                 time: float, config: PipelineConfig,
                 weights: importance_mod.ImportanceWeights | None = None,
                 correlated: bool = True):
    """Advance playback to fractional ``time`` in [0, T): interpolate the
    volume, swap it into the scene, and update the photon map, selectively
    (one correlated step of ``recompute_budget`` photons) when
    ``correlated``, else with a full retrace.

    Returns (scene with the new volume, new state)."""
    telemetry.count("playback.frames")
    telemetry.count_change("playback.new_step",
                           floor_step(time, seq.n_steps))
    if weights is None:
        weights = importance_mod.ImportanceWeights()
    with telemetry.span("playback.mix"):
        data = mixer.sequence_sample(seq.volumes, time)
    scene = dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, data=data))
    if not correlated:
        return scene, pstep.full_trace_step(scene, state, config)
    grid = time_step_importance(
        seq.minmax, seq.diff, time, scene.tf.positions, scene.tf.colors,
        tuple(seq.volumes.shape[1:]), seq.cell_size, weights.normalized())
    # A new time step is a fresh volume invalidation: the drain round
    # restarts, so a stale mask of an unfinished drain suppresses nothing.
    state = dataclasses.replace(
        state, retraced=torch.zeros_like(state.retraced), n_remaining=0)
    budget = pstep.recompute_budget(config, state.photons.n)
    return scene, pstep.correlated_step(scene, state, config, grid, budget)


def play(scene: Scene, state: PhotonMapState, seq: VolumeSequence,
         config: PipelineConfig, n_frames: int | None = None,
         fps_times=None, correlated: bool = True):
    """Play the sequence, yielding (time, scene, state) per frame: at
    ``fps_times``, or at 0, 1, ..., ``n_frames`` - 1 (default: every
    step)."""
    times = (fps_times if fps_times is not None
             else range(n_frames or seq.n_steps))
    for t in times:
        scene, state = advance_time(scene, state, seq, float(t), config,
                                    correlated=correlated)
        yield t, scene, state

"""The interactive frame over a packed state (``cpm_tpu/pipeline/packed.py``):
the correlated update and the sweep render of one frame, with the state
packed into the reference's seven leaves.

The reference packs its state so that a frame crosses its host boundary
once, in one jitted call. The port's frame is one call too; on the card
its trace is one kernel launch (``ops/tracer.py``, ``method="auto"``), so
a frame makes only the host reads that the correlated step makes. The
counters of ``misc`` and the key stay on the host, where the port's
``PhotonMapState`` keeps them as Python numbers, so packing and unpacking
read nothing back from the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import PipelineConfig
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      UniformGrid3D)
from cpm_tpu_torch.ops import rng, sweep_render
from cpm_tpu_torch.pipeline import step as step_mod
from cpm_tpu_torch.pipeline.state import PhotonMapState

Tensor = torch.Tensor


class PackedState(NamedTuple):
    """The reference's seven leaves, in its layouts. The first five lie on
    the state's device; ``misc`` and ``key`` on the host."""

    photon_soa: Tensor  # (I, N, 8) float32: pos3 | pow3 | dir2
    photon_exit: Tensor  # (N, 3) float32: exit_power | exit_dir2
    ls_soa: Tensor  # (N, 11) float32: origins3 | dirs3 | powers3 | tspan2
    light_volume: Tensor  # (D, H, W, 3)
    retraced: Tensor  # (N,) bool
    misc: Tensor  # (6,) float32: radius_rel, scene_radius, iteration,
    #                               n_remaining, recompute_phase, ls_iteration
    key: Tensor  # (2,) uint32


def pack_state(state: PhotonMapState) -> PackedState:
    ph = state.photons
    f32 = torch.float32
    soa = torch.cat([ph.positions.to(f32), ph.powers.to(f32),
                     ph.directions.to(f32)], dim=-1)
    exits = torch.cat([ph.exit_power[:, None].to(f32),
                       ph.exit_direction.to(f32)], dim=-1)
    ls = state.light_samples
    ls_soa = torch.cat([ls.origins, ls.directions, ls.powers, ls.tspan],
                       dim=-1)
    misc = torch.tensor([ph.radius_rel, ph.scene_radius, ph.iteration,
                         state.n_remaining, state.recompute_phase,
                         ls.iteration], dtype=f32)
    key = torch.tensor([int(k) for k in state.key], dtype=torch.uint32)
    return PackedState(photon_soa=soa, photon_exit=exits, ls_soa=ls_soa,
                       light_volume=state.light_volume,
                       retraced=state.retraced, misc=misc, key=key)


def unpack_state(p: PackedState,
                 photon_dtype=torch.float32) -> PhotonMapState:
    """The state of ``p``, the deposit fields in ``photon_dtype`` (a torch
    dtype or its name); the progressive average is the light volume."""
    if isinstance(photon_dtype, str):
        photon_dtype = getattr(torch, photon_dtype)
    soa = p.photon_soa
    radius_rel, scene_radius, iteration, n_remaining, phase, ls_iteration = (
        p.misc.tolist())
    photons = PhotonData(
        positions=soa[..., 0:3].to(photon_dtype),
        powers=soa[..., 3:6].to(photon_dtype),
        directions=soa[..., 6:8].to(photon_dtype),
        exit_power=p.photon_exit[:, 0], exit_direction=p.photon_exit[:, 1:3],
        radius_rel=radius_rel, scene_radius=scene_radius,
        iteration=int(iteration))
    ls = LightSamples(
        origins=p.ls_soa[:, 0:3], directions=p.ls_soa[:, 3:6],
        powers=p.ls_soa[:, 6:9], tspan=p.ls_soa[:, 9:11],
        iteration=int(ls_iteration))
    return PhotonMapState(
        photons=photons, light_samples=ls, light_volume=p.light_volume,
        light_volume_accum=p.light_volume,
        key=tuple(int(k) for k in p.key.tolist()), retraced=p.retraced,
        n_remaining=int(n_remaining), recompute_phase=int(phase))


def interactive_frame(scene: Scene, packed: PackedState, camera: Camera,
                      imp_grid: UniformGrid3D, config: PipelineConfig,
                      budget: int, fresh_round: bool = False,
                      do_render: bool = True):
    """One interactive frame: the key advanced by ``fold_in(key, 1)``, one
    ``correlated_step`` of ``budget`` photons, and the sweep render of the
    light volume along ``camera``'s principal axis. ``fresh_round=True``
    restarts the drain round (a new TF or volume invalidation);
    ``do_render=False`` runs the packed correlated update alone and
    returns a (0, 0, 4) image. Returns (packed state, image)."""
    state = unpack_state(packed)
    if fresh_round:
        state = dataclasses.replace(
            state, retraced=torch.zeros_like(state.retraced), n_remaining=0)
    state = dataclasses.replace(state, key=rng.fold_in(state.key, 1))
    state = step_mod.correlated_step(scene, state, config, imp_grid, budget)
    if not do_render:
        return pack_state(state), torch.zeros(
            (0, 0, 4), dtype=torch.float32, device=scene.device)
    img = sweep_render.sweep_render(scene.volume, scene.tf,
                                    state.light_volume_accum, camera,
                                    config.render)
    return pack_state(state), img

"""Pipeline orchestration: the forward frame
(``cpm_tpu/pipeline/step.py``: ``emit_all`` :52-93, ``init_state``
:132-155, ``full_trace_step`` :169-199, ``render_state`` :611-625).

Entry points, in the order a user calls them: :func:`init_state` ->
:func:`full_trace_step` -> :func:`render_state`. Everything runs on the
device of the scene's tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from cpm_tpu_torch.core.config import PipelineConfig
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import LightSamples, PhotonData, f32_scalar
from cpm_tpu_torch.ops import emit as emit_mod
from cpm_tpu_torch.ops import rng, sampling, splat, sweep_render, tracer
from cpm_tpu_torch.pipeline.state import PhotonMapState

Tensor = torch.Tensor


def emit_all(scene: Scene, config: PipelineConfig) -> LightSamples:
    """Emit the light-sample bundle of every light, concatenated; N =
    photons_x * photons_y samples per light, in linear sample order.
    Directional emission draws no random numbers, so it takes no key."""
    if config.sample_order != "linear":
        raise NotImplementedError(
            f"sample_order={config.sample_order!r} is not ported yet")
    if config.guided_emission:
        raise NotImplementedError("guided emission is not ported yet")
    grid = sampling.stratified_grid_2d(config.photons_x, config.photons_y,
                                       device=scene.device)
    bundles = [emit_mod.emit(light, grid) for light in scene.lights]
    if len(bundles) == 1:
        return bundles[0]
    return LightSamples(
        origins=torch.cat([b.origins for b in bundles]),
        directions=torch.cat([b.directions for b in bundles]),
        powers=torch.cat([b.powers for b in bundles]),
        tspan=torch.cat([b.tspan for b in bundles]),
        iteration=bundles[0].iteration,
    )


def light_volume_shape(config: PipelineConfig) -> tuple:
    if config.splat.volume_size_from_radius:
        d = splat.light_volume_dim(config.tracer.radius_rel)
    else:
        d = config.splat.volume_dim
    return (d, d, d)


def splat_method(config: PipelineConfig, device: torch.device) -> str:
    """Resolve the splat backend ("auto" picks by the tensors' device)."""
    if config.splat.method == "auto":
        return splat.default_method(device)
    return config.splat.method


def splat_footprint(config: PipelineConfig) -> int:
    """Static radial-splat footprint, validated against the photon radius:
    the AABB spans at most floor(2*r*dim) + 2 voxels per axis."""
    dim = max(light_volume_shape(config))
    required = int(2.0 * config.tracer.radius_rel * dim) + 2
    fp = max(config.splat.footprint, required)
    if fp > 16:
        raise ValueError(
            f"splat footprint {fp} (radius_rel={config.tracer.radius_rel}, "
            f"light volume dim={dim}) exceeds 16 voxels; use a coarser light "
            "volume or a smaller radius")
    return fp


def init_state(scene: Scene, config: PipelineConfig,
               seed: int = 0) -> PhotonMapState:
    """Fresh state: emitted light samples, empty photon buffer, zero light
    volume; ``seed`` roots the state's threefry key."""
    ls = emit_all(scene, config)
    dev = scene.device
    photons = PhotonData.create(
        ls.n, config.tracer.max_interactions,
        radius_rel=config.tracer.radius_rel,
        scene_radius=scene.volume.scene_radius(), device=dev)
    zeros = torch.zeros((*light_volume_shape(config), 3),
                        dtype=torch.float32, device=dev)
    return PhotonMapState(
        photons=photons, light_samples=ls, light_volume=zeros,
        light_volume_accum=zeros, key=rng.prng_key(seed),
        retraced=torch.zeros(ls.n, dtype=torch.bool, device=dev),
        n_remaining=0, recompute_phase=0)


def full_trace_step(scene: Scene, state: PhotonMapState,
                    config: PipelineConfig) -> PhotonMapState:
    """Trace every light sample and rebuild the light volume, restarting
    the progressive iteration at 0."""
    if config.tracer.trace_chunk:
        raise NotImplementedError("trace_chunk is not ported yet")
    iteration = 0
    key = rng.fold_in(state.key, iteration)
    photons = tracer.trace_photons(
        scene.volume, scene.tf, scene.tf_scattering, state.light_samples,
        key, config.tracer)
    photons = dataclasses.replace(
        photons, iteration=iteration,
        radius_rel=f32_scalar(config.tracer.radius_rel),
        scene_radius=scene.volume.scene_radius())
    lv = splat.splat_all(photons, light_volume_shape(config),
                         splat_footprint(config),
                         method=splat_method(config, scene.device))
    return dataclasses.replace(
        state, photons=photons, light_volume=lv, light_volume_accum=lv,
        retraced=torch.zeros(photons.n, dtype=torch.bool,
                             device=scene.device),
        n_remaining=0)


def render_state(scene: Scene, state: PhotonMapState,
                 config: PipelineConfig) -> Tensor:
    """Composite the progressive light volume into an (H, W, 4) image with
    the sweep renderer."""
    if config.render.method != "sweep":
        raise NotImplementedError(
            f"render method {config.render.method!r} is not ported yet")
    return sweep_render.sweep_render(
        scene.volume, scene.tf, state.light_volume_accum, scene.camera,
        config.render)

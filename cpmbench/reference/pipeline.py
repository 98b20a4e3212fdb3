"""The reference pipeline: the plain forms composed as the port's entry
points compose them (``cpm_tpu_torch/pipeline/step.py``), written against
the frozen copies in this folder and nothing of the program.

Every stage takes a :class:`Precision`: :data:`EXACT` for the reference
(float32, its matrix products in full float32), :data:`TF32` for its
control (the products in TF32, the nearest precision below), and
:data:`BFLOAT16`, every volume, photon field, light volume and image
stored in bfloat16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from cpmbench.reference import emit as emit_mod
from cpmbench.reference import (importance, minmax, path_importance, rng,
                                sampling, select, splat, sweep_render,
                                tracer)
from cpmbench.reference import lights as L
from cpmbench.reference.camera import Camera
from cpmbench.reference.config import PipelineConfig
from cpmbench.reference.types import (LightSamples, PhotonData,
                                      TransferFunction, UniformGrid3D,
                                      Volume, f32_scalar,
                                      progressive_sphere_radius)

Tensor = torch.Tensor
Quantize = Callable[[Tensor], Tensor]


def exact(t: Tensor) -> Tensor:
    return t


def bfloat16_storage(t: Tensor) -> Tensor:
    """``t`` stored in bfloat16 and read back as its own type."""
    if not t.is_floating_point():
        return t
    return t.to(torch.bfloat16).to(t.dtype)


@dataclass(frozen=True)
class Precision:
    """``quantize`` is applied to each stage's floating-point inputs and
    outputs; ``tf32`` lets float32 matrix products (the splat's
    contraction, the sweep's hat-matrix products) run in TF32."""

    quantize: Quantize = exact
    tf32: bool = False


EXACT = Precision()
TF32 = Precision(tf32=True)
BFLOAT16 = Precision(quantize=bfloat16_storage)
CONTROLS = {"tf32": TF32, "bfloat16": BFLOAT16}


@contextlib.contextmanager
def matmuls(p: Precision):
    """float32 matrix products in TF32 or in full float32 for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = p.tf32
    torch.backends.cudnn.allow_tf32 = p.tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclass
class Scene:
    volume: Volume
    tf: TransferFunction
    tf_scattering: TransferFunction
    lights: tuple  # of lights.Light
    camera: Camera


def _photons(ph: PhotonData, q: Quantize) -> PhotonData:
    return dataclasses.replace(
        ph, positions=q(ph.positions), powers=q(ph.powers),
        directions=q(ph.directions), exit_power=q(ph.exit_power),
        exit_direction=q(ph.exit_direction))


def _volume(scene: Scene, q: Quantize) -> Scene:
    return dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, data=q(scene.volume.data)))


def light_volume_shape(config: PipelineConfig) -> tuple:
    d = splat.light_volume_dim(config.tracer.radius_rel)
    return (d, d, d)


def emit_all(scene: Scene, config: PipelineConfig, key: tuple,
             importance_grid: UniformGrid3D | None = None) -> LightSamples:
    """Every light's samples in linear order, concatenated; light i draws
    under ``fold_in(key, i)``; with ``config.guided_emission`` each
    directional light's grid is warped by the importance grid's guide."""
    grid = sampling.stratified_grid_2d(config.photons_x, config.photons_y,
                                       device=scene.volume.device)
    bundles = []
    for i, light in enumerate(scene.lights):
        g = grid
        if (config.guided_emission and importance_grid is not None
                and light.type == L.DIRECTIONAL):
            guide = emit_mod.build_emission_guide(
                importance_grid, light, n_u=config.guide_resolution,
                n_v=config.guide_resolution)
            g = sampling.warp_samples_2d(grid, guide,
                                         floor=config.guide_floor)
        bundles.append(emit_mod.emit(light, g, key=rng.fold_in(key, i)))
    return LightSamples(
        origins=torch.cat([b.origins for b in bundles]),
        directions=torch.cat([b.directions for b in bundles]),
        powers=torch.cat([b.powers for b in bundles]),
        tspan=torch.cat([b.tspan for b in bundles]),
        iteration=bundles[0].iteration)


def light_samples(scene: Scene, config: PipelineConfig, seed: int,
                  importance_grid: UniformGrid3D | None = None):
    """(root key, the light samples) of a fresh state rooted at ``seed``:
    emission draws under ``fold_in(key, 1)``."""
    key = rng.prng_key(seed)
    return key, emit_all(scene, config, rng.fold_in(key, 1), importance_grid)


def trace(scene: Scene, samples: LightSamples, key: tuple,
          config: PipelineConfig, iteration: int, radius_rel: float,
          lane_ids: Tensor | None = None, p: Precision = EXACT,
          counts: bool = False):
    """The photons of one trace under ``fold_in(key, iteration)``, with
    their progressive fields set; with ``counts`` also the trace's work."""
    q = p.quantize
    out = tracer.trace_photons(
        _volume(scene, q).volume, scene.tf, scene.tf_scattering, samples,
        rng.fold_in(key, iteration), config.tracer, lane_ids=lane_ids,
        counts=counts)
    photons, work = out if counts else (out, None)
    photons = _photons(dataclasses.replace(
        photons, iteration=iteration, radius_rel=radius_rel,
        scene_radius=scene.volume.scene_radius()), q)
    return (photons, work) if counts else photons


def full_trace(scene: Scene, samples: LightSamples, key: tuple,
               config: PipelineConfig, p: Precision = EXACT,
               counts: bool = False):
    """``full_trace_step``: (photons, light volume[, work])."""
    out = trace(scene, samples, key, config, 0,
                f32_scalar(config.tracer.radius_rel), p=p, counts=counts)
    photons = out[0] if counts else out
    with matmuls(p):
        lv = p.quantize(splat.splat_all(photons, light_volume_shape(config)))
    return (photons, lv, out[1]) if counts else (photons, lv)


def progressive_pass(scene: Scene, samples: LightSamples, key: tuple,
                     config: PipelineConfig, iteration: int,
                     radius_before: float, accum_before: Tensor,
                     p: Precision = EXACT):
    """``progressive_step`` from iteration - 1 with radius
    ``radius_before`` and running mean ``accum_before``: (photons, light
    volume, running mean)."""
    radius = progressive_sphere_radius(radius_before, iteration,
                                       config.tracer.alpha)
    q = p.quantize
    photons = trace(scene, samples, key, config, iteration, radius, p=p)
    with matmuls(p):
        lv = q(splat.splat_all(photons, light_volume_shape(config)))
    it = torch.tensor(float(iteration), dtype=torch.float32,
                      device=lv.device)
    accum = q((q(accum_before) * it + lv) / (it + 1.0))
    return photons, lv, accum


def build_importance_grid(scene: Scene,
                          config: PipelineConfig) -> UniformGrid3D:
    """min/max grid -> TF-classified importance grid (default weights)."""
    w = importance.ImportanceWeights().normalized()
    mm = minmax.volume_min_max(scene.volume, config.recompute.grid_cell_size)
    imp = importance.classify_importance(mm.data, scene.tf.positions,
                                         scene.tf.colors, w)
    return dataclasses.replace(mm, data=imp)


def build_tf_change_importance_grid(scene: Scene, config: PipelineConfig,
                                    prev_positions, prev_colors
                                    ) -> UniformGrid3D:
    """The importance of the cells whose appearance a TF edit changed;
    the previous and the edited TF's points as numpy arrays or tensors."""
    mm = minmax.volume_min_max(scene.volume, config.recompute.grid_cell_size)

    def host(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) else t

    dpos, dcol = importance.tf_difference_points(
        host(prev_positions), host(prev_colors), host(scene.tf.positions),
        host(scene.tf.colors))
    dev = scene.volume.device
    imp = importance.classify_importance(
        mm.data, torch.from_numpy(dpos).to(dev),
        torch.from_numpy(dcol).to(dev), weights=None, incremental=True)
    return dataclasses.replace(mm, data=imp)


def recompute_budget(config: PipelineConfig, n_photons: int) -> int:
    b = int(math.ceil(config.recompute.max_photons_fraction * n_photons))
    return max(256, -(-b // 256) * 256)


def correlated_update(scene: Scene, samples: LightSamples, key: tuple,
                      config: PipelineConfig, photons: PhotonData,
                      light_volume: Tensor, retraced: Tensor,
                      grid: UniformGrid3D, budget: int,
                      p: Precision = EXACT) -> dict:
    """``correlated_step_scalable`` from ``photons`` and ``light_volume``:
    path importance over the dilated grid, the top-``budget`` selection
    without ``retraced``, the retrace of the selected samples under their
    own streams, and the removed and added splats. Returns the selection
    (``indices``, ``valid``), the merged ``photons`` and ``light_volume``."""
    photons = dataclasses.replace(
        photons, iteration=0, radius_rel=f32_scalar(config.tracer.radius_rel))
    r = config.tracer.block_ring
    dilated = F.max_pool3d(grid.data[None, None], 2 * r + 1, stride=1,
                           padding=r)[0, 0]
    imp = path_importance.photon_path_importance(
        dataclasses.replace(grid, data=dilated), photons, samples,
        max_steps=config.recompute.importance_steps,
        mode=config.recompute.importance_mode,
        n_samples=config.recompute.importance_quadrature_samples)
    indices, valid, _ = select.select_photons_to_recompute(imp, budget,
                                                           exclude=retraced)
    safe = torch.where(valid, indices, 0)
    never = torch.tensor([0.0, -1.0], dtype=torch.float32,
                         device=indices.device)
    sub = LightSamples(
        origins=samples.origins[safe], directions=samples.directions[safe],
        powers=samples.powers[safe],
        tspan=torch.where(valid[:, None], samples.tspan[safe], never),
        iteration=samples.iteration)
    new = trace(scene, sub, key, config, 0, photons.radius_rel,
                lane_ids=safe, p=p)
    merged = tracer.merge_recomputed(photons, new, indices, valid)
    dim = light_volume_shape(config)
    with matmuls(p):
        removed = splat.splat_selected(photons, indices, valid, dim)
        added = splat.splat_selected(merged, indices, valid, dim)
    return {"indices": indices, "valid": valid, "photons": merged,
            "light_volume": p.quantize(light_volume - removed + added)}


def render(scene: Scene, light_volume: Tensor, config: PipelineConfig,
           rows: Tensor | None = None, p: Precision = EXACT) -> Tensor:
    """The sweep render of ``light_volume`` through ``scene.camera``; with
    ``rows``, only those image rows."""
    q = p.quantize
    s = _volume(scene, q)
    with matmuls(p):
        return q(sweep_render.sweep_render(s.volume, s.tf, q(light_volume),
                                           s.camera, config.render,
                                           rows=rows))

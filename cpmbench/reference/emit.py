"""Light-sample emission (``cpm_tpu/ops/emit.py``): directional lights
(a light of another type brings its own emission, ``cpmbench/lights/``),
the dispatcher ``emit`` and the guide
of importance-guided emission, ``build_emission_guide``. The light-plane
fit is host work in numpy (``lightplane.py``)."""

from __future__ import annotations

import numpy as np
import torch

from cpmbench.reference import lights as L
from cpmbench.reference.types import LightSamples, UniformGrid3D
from cpmbench.reference import intersect, lightplane

Tensor = torch.Tensor


def _vec(v, device) -> Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _box(b, device) -> Tensor:
    return _vec(b, device).expand(3)


def emit_directional(light: L.Light, samples: Tensor,
                     scene_points: np.ndarray | None = None,
                     box_min=0.0, box_max=1.0,
                     iteration: int = 0) -> LightSamples:
    """Place (N, 4) (u, v, _, pdf) samples on the light plane fitted to
    ``scene_points`` (the box's corners by default) for a directional
    light; power = radiance * area / pdf."""
    if scene_points is None:
        scene_points = lightplane.unit_box_corners(box_min, box_max)
    origin, tu, tv, area = lightplane.fit_light_plane(
        scene_points, np.asarray(light.direction))
    dev = samples.device
    origins = (_vec(origin, dev)[None, :] + _vec(tu, dev)[None, :]
               * samples[:, 0:1] + _vec(tv, dev)[None, :] * samples[:, 1:2])
    directions = _vec(light.direction, dev).expand(origins.shape).contiguous()
    pdf = samples[:, 3] / _vec(area, dev)
    powers = _vec(light.radiance, dev)[None, :] / pdf[:, None]
    tspan = intersect.light_sample_box_intersection(origins, directions,
                                                    box_min, box_max)
    return LightSamples(origins=origins, directions=directions,
                        powers=powers, tspan=tspan, iteration=int(iteration))


def build_emission_guide(importance_grid: UniformGrid3D, light: L.Light,
                         n_u: int = 64, n_v: int = 64, n_steps: int = 32,
                         scene_points: np.ndarray | None = None,
                         box_min=0.0, box_max=1.0) -> Tensor:
    """(n_v, n_u) guide map for importance-guided emission of a directional
    light: each texel is the mean of the importance grid over ``n_steps``
    midpoints of the light ray through the texel's point of the fitted
    light plane, times the ray's span in the box. Feed it to
    :func:`cpmbench.reference.sampling.warp_samples_2d`."""
    if light.type != L.DIRECTIONAL:
        raise ValueError("guided emission supports directional lights")
    if scene_points is None:
        scene_points = lightplane.unit_box_corners(box_min, box_max)
    origin, tu, tv, _ = lightplane.fit_light_plane(
        scene_points, np.asarray(light.direction))
    grid = importance_grid.data
    dev = grid.device
    f32 = dict(dtype=torch.float32, device=dev)
    us = (torch.arange(n_u, **f32) + 0.5) / n_u
    vs = (torch.arange(n_v, **f32) + 0.5) / n_v
    o = (_vec(origin, dev)[None, None, :]
         + _vec(tu, dev)[None, None, :] * us[None, :, None]
         + _vec(tv, dev)[None, None, :] * vs[:, None, None]).reshape(-1, 3)
    dirs = _vec(light.direction, dev).expand(o.shape)
    hit, t0, t1 = intersect.ray_box(o, dirs, box_min, box_max)
    ts = (torch.arange(n_steps, **f32) + 0.5) / n_steps
    t = t0[None, :] + ts[:, None] * (t1 - t0)[None, :]  # (K, M)
    p = o[None, :, :] + t[..., None] * dirs[None, :, :]
    gz, gy, gx = grid.shape
    c = torch.floor(p * torch.tensor([gx, gy, gz], **f32))
    c = torch.clamp(c, min=torch.zeros(3, **f32),
                    max=torch.tensor([gx - 1, gy - 1, gz - 1], **f32)).long()
    vals = grid.reshape(-1)[(c[..., 2] * gy + c[..., 1]) * gx + c[..., 0]]
    span = torch.clamp(t1 - t0, min=0.0) * hit.to(torch.float32)
    return (vals.mean(dim=0) * span).reshape(n_v, n_u)


def emit(light: L.Light, samples: Tensor, key: tuple | None = None,
         scene_points: np.ndarray | None = None, box_min=0.0, box_max=1.0,
         iteration: int = 0) -> LightSamples:
    """Dispatch on the light type."""
    if light.type == L.DIRECTIONAL:
        return emit_directional(light, samples, scene_points, box_min,
                                box_max, iteration)
    emit_own = getattr(light, "emit", None)
    if emit_own is None:
        raise ValueError(f"the reference emits directional lights only, "
                         f"not type {light.type}")
    return emit_own(samples, key=key, box_min=box_min, box_max=box_max,
                    iteration=iteration)

"""Light-sample emission (``cpm_tpu/ops/emit.py``): directional, point,
cone and area lights (:31-142), the dispatcher ``emit`` (:235-248), and the
two guides of importance-guided emission, ``build_emission_guide``
(:145-198) and ``emission_guide_from_wave`` (:201-232).

The light-plane fit is host work in numpy (``ops/lightplane.py``); an area
light's random targets are the draws of ``jax.random.uniform`` under the
same key (``ops/rng.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpm_tpu_torch.core import lights as L
from cpm_tpu_torch.core.types import LightSamples, UniformGrid3D
from cpm_tpu_torch.ops import intersect, lightplane, rng
from cpm_tpu_torch.ops.phase import _orthonormal_frame

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


def _from_light(light: L.Light, directions: Tensor, powers: Tensor,
                box_min, box_max, iteration: int) -> LightSamples:
    """A bundle of rays leaving the light's position."""
    origins = _vec(light.position, directions.device).expand(
        directions.shape).contiguous()
    tspan = intersect.light_sample_box_intersection(origins, directions,
                                                    box_min, box_max)
    return LightSamples(origins=origins, directions=directions,
                        powers=powers.contiguous(), tspan=tspan,
                        iteration=int(iteration))


def emit_point(light: L.Light, samples: Tensor, box_min=0.0, box_max=1.0,
               iteration: int = 0) -> LightSamples:
    """Point light: uniform sphere directions from (u, v); pdf = 1/(4 pi),
    power = radiance / pdf."""
    u, v = samples[:, 0], samples[:, 1]
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * v
    directions = -torch.stack([r * torch.cos(phi), r * torch.sin(phi), z],
                              dim=-1)
    pdf = 1.0 / (4.0 * math.pi)
    powers = (_vec(light.radiance, samples.device) / pdf).expand(
        directions.shape)
    return _from_light(light, directions, powers, box_min, box_max,
                       iteration)


def emit_cone(light: L.Light, samples: Tensor, box_min=0.0, box_max=1.0,
              iteration: int = 0) -> LightSamples:
    """Cone light: uniform directions in the cone of half-angle
    acos(cos_fov) around the light's axis; pdf = 1/(2 pi (1 - cos_fov)),
    power = z^5 * radiance / pdf (the reference's falloff)."""
    dev = samples.device
    u, v = samples[:, 0], samples[:, 1]
    cos_fov = _vec(light.cos_fov, dev)
    z = 1.0 - u * (1.0 - cos_fov)  # cos(theta) in [cos_fov, 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * v
    axis = _vec(light.direction, dev)
    t, b = _orthonormal_frame(axis)
    directions = (t[None] * (r * torch.cos(phi))[:, None]
                  + b[None] * (r * torch.sin(phi))[:, None]
                  + axis[None] * z[:, None])
    pdf = 1.0 / (2.0 * math.pi * torch.clamp(1.0 - cos_fov, min=1e-6))
    powers = (z ** 5)[:, None] * _vec(light.radiance, dev)[None] / pdf
    return _from_light(light, directions, powers, box_min, box_max,
                       iteration)


def emit_area(light: L.Light, samples: Tensor, key: tuple | None = None,
              box_min=0.0, box_max=1.0, iteration: int = 0) -> LightSamples:
    """Area light: origins across the rectangle, each aimed at a random
    point of the box drawn under ``key`` ((k0, k1), default
    ``prng_key(0)``); pdf = area."""
    dev = samples.device
    u, v = samples[:, 0], samples[:, 1]
    t, b = _orthonormal_frame(_vec(light.direction, dev))
    size = _vec(light.size, dev)
    center = _vec(light.position, dev)
    origins = (center[None] + t[None] * (size[0] * (u - 0.5))[:, None]
               + b[None] * (size[1] * (v - 0.5))[:, None])
    if key is None:
        key = rng.prng_key(0)
    lo, hi = _box(box_min, dev), _box(box_max, dev)
    target = lo + (hi - lo) * rng.uniform(key, origins.shape, dev)
    directions = target - origins
    directions = directions / torch.linalg.vector_norm(
        directions, dim=-1, keepdim=True)
    powers = (_vec(light.radiance, dev) / (size[0] * size[1])).expand(
        origins.shape).contiguous()
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
    :func:`cpm_tpu_torch.ops.sampling.warp_samples_2d`."""
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


def emission_guide_from_wave(uv: Tensor, pdf: Tensor, deposits: Tensor,
                             n_u: int = 64, n_v: int = 64) -> Tensor:
    """Adaptive emission guide: the measured contribution per light-plane
    bin. Each sample's deposited luminance times its emission pdf estimates
    the contribution at its plane position without bias; the mean over the
    samples in each of (n_v, n_u) bins is the guide.

    Args:
      uv: (N, 2) plane coordinates the samples were emitted at (warped).
      pdf: (N,) their emission pdfs (samples[:, 3] after any warp).
      deposits: (I, N, 3) stored deposit powers (``PhotonData.powers``).
    """
    lum = deposits.abs().sum(dim=(0, 2))
    lum = torch.where(torch.isfinite(lum), lum, 0.0)
    contrib = lum * pdf
    iu = torch.clamp((uv[:, 0] * n_u).to(torch.int32), 0, n_u - 1)
    iv = torch.clamp((uv[:, 1] * n_v).to(torch.int32), 0, n_v - 1)
    flat = (iv * n_u + iu).long()
    tot = torch.zeros(n_v * n_u, dtype=torch.float32, device=uv.device)
    cnt = torch.zeros_like(tot)
    tot.index_add_(0, flat, contrib)
    cnt.index_add_(0, flat, torch.ones_like(contrib))
    return (tot / torch.clamp(cnt, min=1.0)).reshape(n_v, n_u)


def emit(light: L.Light, samples: Tensor, key: tuple | None = None,
         scene_points: np.ndarray | None = None, box_min=0.0, box_max=1.0,
         iteration: int = 0) -> LightSamples:
    """Dispatch on the light type."""
    if light.type == L.DIRECTIONAL:
        return emit_directional(light, samples, scene_points, box_min,
                                box_max, iteration)
    if light.type == L.POINT:
        return emit_point(light, samples, box_min, box_max, iteration)
    if light.type == L.CONE:
        return emit_cone(light, samples, box_min, box_max, iteration)
    if light.type == L.AREA:
        return emit_area(light, samples, key, box_min, box_max, iteration)
    raise ValueError(f"unknown light type {light.type}")

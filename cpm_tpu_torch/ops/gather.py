"""Camera ray march with light-volume sampling (``cpm_tpu/ops/gather.py``):
per-pixel entry/exit spans against the unit box, then a fixed number of
depth steps in which every pixel samples the density, the transfer
function and the light volume.

Emission-absorption volume rendering: extinction = TF opacity *
SAMPLING_BASE_INTERVAL_RCP, emitted radiance = TF colour * (irradiance +
ambient); the light volume already carries the phase factor and the
irradiance normalization of the splat.

The marcher is the physics oracle of the sweep renderer and renders any
camera. :func:`render_rays` is the dense form, one (chunk, steps) batch of
samples per chunk of rays; :func:`render_rays_loop` its sequential twin,
one step of every ray at a time.
"""

from __future__ import annotations

import torch

from cpm_tpu_torch.core import constants
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import RenderConfig
from cpm_tpu_torch.core.types import TransferFunction, Volume
from cpm_tpu_torch.ops import intersect
from cpm_tpu_torch.ops.sampling import (sample_volume_trilinear,
                                        sample_volume_trilinear_vec)

Tensor = torch.Tensor

# Samples a chunk of :func:`render_rays` holds at once (chunk * n_steps).
CHUNK_SAMPLES = 1 << 23


def default_steps(volume: Volume, sampling_rate: float) -> int:
    """Steps along the unit box's diagonal: sqrt(3) * max dim * rate + 1."""
    return int(3 ** 0.5 * max(volume.data.shape) * sampling_rate) + 1


def render(volume: Volume, tf: TransferFunction, light_volume: Tensor,
           camera: Camera, config: RenderConfig,
           n_steps: int | None = None) -> Tensor:
    """Render an (H, W, 4) RGBA image from the (D, H, W, 3) light volume
    with ``n_steps`` steps (:func:`default_steps` by default)."""
    h, w = config.height, config.width
    origins, dirs = camera.rays(w, h)
    if n_steps is None:
        n_steps = default_steps(volume, config.sampling_rate)
    img = render_rays(volume, tf, light_volume, origins.reshape(-1, 3),
                      dirs.reshape(-1, 3), n_steps, config.ambient)
    return img.reshape(h, w, 4)


def _spans(o: Tensor, d: Tensor, n_steps: int):
    """(t0, t1, dt): the rays' spans through the unit box, misses (0, -1),
    and the step length sqrt(3) / (n_steps - 1)."""
    hit, t0, t1 = intersect.ray_box(o, d)
    t0 = torch.where(hit, t0, 0.0)
    t1 = torch.where(hit, t1, -1.0)
    dt = 3 ** 0.5 / (n_steps - 1) if n_steps > 1 else 1.0
    return t0, t1, dt


def _march_chunk(volume: Volume, tf: TransferFunction, light_volume: Tensor,
                 o: Tensor, d: Tensor, t0: Tensor, t1: Tensor, n_steps: int,
                 dt: float, ambient: float) -> Tensor:
    """Dense march of a (C, 3) ray chunk as one (C, S) sample batch: the
    steps outside [t0, t1] get tau = 0, and front-to-back compositing is
    the exclusive cumulative sum of tau along the steps."""
    sigma_scale = constants.SAMPLING_BASE_INTERVAL_RCP
    s = (torch.arange(n_steps, dtype=torch.float32, device=o.device)
         + 0.5) * dt  # (S,)
    t = t0[:, None] + s[None, :]  # (C, S)
    inside = t <= t1[:, None]
    p = o[:, None, :] + t[..., None] * d[:, None, :]  # (C, S, 3)
    color = tf.sample(sample_volume_trilinear(volume.data, p))  # (C, S, 4)
    light = sample_volume_trilinear_vec(light_volume, p)  # (C, S, 3)
    tau = torch.where(inside, color[..., 3] * sigma_scale * dt, 0.0)
    seg_a = 1.0 - torch.exp(-tau)
    trans = torch.exp(-(torch.cumsum(tau, dim=1) - tau))  # exclusive
    emit = color[..., :3] * (light + ambient)
    rgb = torch.sum((trans * seg_a)[..., None] * emit, dim=1)
    alpha = 1.0 - torch.exp(-torch.sum(tau, dim=1))
    return torch.cat([rgb, alpha[:, None]], dim=-1)


def render_rays(volume: Volume, tf: TransferFunction, light_volume: Tensor,
                o: Tensor, d: Tensor, n_steps: int, ambient: float = 0.05,
                chunk: int | None = None) -> Tensor:
    """Ray-march a flat (P, 3) ray bundle into (P, 4) RGBA, ``chunk`` rays
    at a time (:func:`chunk_size` by default); the last chunk may be
    shorter. A ray's result does not depend on the chunking."""
    t0, t1, dt = _spans(o, d, n_steps)
    npix = o.shape[0]
    chunk = min(chunk or chunk_size(n_steps), npix)
    outs = [_march_chunk(volume, tf, light_volume, o[lo:lo + chunk],
                         d[lo:lo + chunk], t0[lo:lo + chunk],
                         t1[lo:lo + chunk], n_steps, dt, ambient)
            for lo in range(0, npix, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def chunk_size(n_steps: int) -> int:
    """The default rays a chunk of :func:`render_rays`: as many as keep
    CHUNK_SAMPLES samples, at least 1024."""
    return max(1024, CHUNK_SAMPLES // max(n_steps, 1))


def render_rays_loop(volume: Volume, tf: TransferFunction,
                     light_volume: Tensor, o: Tensor, d: Tensor,
                     n_steps: int, ambient: float = 0.05) -> Tensor:
    """The sequential marcher, one step of every ray at a time with the
    analytic transmittance of each segment: the same math as
    :func:`render_rays`, its allclose oracle."""
    t0, t1, dt = _spans(o, d, n_steps)
    sigma_scale = constants.SAMPLING_BASE_INTERVAL_RCP
    npix = o.shape[0]
    rgb = torch.zeros((npix, 3), dtype=torch.float32, device=o.device)
    trans = torch.ones(npix, dtype=torch.float32, device=o.device)
    for i in range(n_steps):
        t = t0 + (i + 0.5) * dt
        inside = t <= t1
        p = o + t[:, None] * d
        color = tf.sample(sample_volume_trilinear(volume.data, p))
        light = sample_volume_trilinear_vec(light_volume, p)
        emit = color[:, :3] * (light + ambient)
        seg_t = torch.exp(-(color[:, 3] * sigma_scale) * dt)
        contrib = trans[:, None] * (1.0 - seg_t)[:, None] * emit
        rgb = rgb + torch.where(inside[:, None], contrib, 0.0)
        trans = torch.where(inside, trans * seg_t, trans)
    return torch.cat([rgb, (1.0 - trans)[:, None]], dim=-1)


def transmittance_to_point(volume: Volume, tf: TransferFunction,
                           origin: Tensor, target: Tensor,
                           n_steps: int = 128) -> Tensor:
    """Transmittance between texture-space points (..., 3), by a midpoint
    march of ``n_steps`` steps (cl/transmittance.cl:42-62)."""
    delta = target - origin
    length = torch.linalg.vector_norm(delta, dim=-1)
    d = delta / torch.clamp(length, min=1e-8)[..., None]
    dt = length / n_steps
    thick = torch.zeros_like(length)
    for i in range(n_steps):
        p = origin + ((i + 0.5) * dt)[..., None] * d
        thick = thick + tf.sample_opacity(sample_volume_trilinear(
            volume.data, p))
    return torch.exp(-thick * dt * constants.SAMPLING_BASE_INTERVAL_RCP)

"""Phase functions: evaluation and direction sampling
(``cpm_tpu/ops/phase.py:24-101``).

``g`` is a float32 scalar: it is turned into a 0-d tensor so every product
rounds in float32, as the reference's does.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

ISOTROPIC = 0
HENYEY_GREENSTEIN = 1
SCHLICK = 2

INV_4PI = 1.0 / (4.0 * math.pi)


def hg_phase(cos_theta: Tensor, g: Tensor) -> Tensor:
    g2 = g * g
    denom = torch.clamp(1.0 + g2 - 2.0 * g * cos_theta, min=1e-8)
    return INV_4PI * (1.0 - g2) / (denom * torch.sqrt(denom))


def schlick_phase(cos_theta: Tensor, k: Tensor) -> Tensor:
    denom = torch.clamp(1.0 + k * cos_theta, min=1e-4)
    return INV_4PI * (1.0 - k * k) / (denom * denom)


def _orthonormal_frame(w: Tensor):
    """Build (u, v) orthogonal to w; w is (..., 3) normalized."""
    sign = torch.where(w[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + w[..., 2])
    b = w[..., 0] * w[..., 1] * a
    u = torch.stack([1.0 + sign * w[..., 0] ** 2 * a, sign * b,
                     -sign * w[..., 0]], dim=-1)
    v = torch.stack([b, sign + w[..., 1] ** 2 * a, -w[..., 1]], dim=-1)
    return u, v


def _from_cos_theta(wi: Tensor, cos_theta: Tensor, u2: Tensor) -> Tensor:
    """Direction at polar angle acos(cos_theta) around wi, azimuth 2*pi*u2."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u2
    t, b = _orthonormal_frame(wi)
    return (t * (sin_theta * torch.cos(phi))[..., None]
            + b * (sin_theta * torch.sin(phi))[..., None]
            + wi * cos_theta[..., None])


def _scalar(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def sample_isotropic(wi: Tensor, u1: Tensor, u2: Tensor):
    cos_theta = 1.0 - 2.0 * u1
    wo = _from_cos_theta(wi, cos_theta, u2)
    pdf = torch.full(u1.shape, INV_4PI, dtype=torch.float32, device=u1.device)
    return wo, pdf


def sample_hg(wi: Tensor, g, u1: Tensor, u2: Tensor):
    g = _scalar(g, u1)
    safe = torch.abs(g) > 1e-3
    gs = torch.where(safe, g, 1.0)  # avoid /0 in the unused branch
    sqr = (1.0 - gs * gs) / (1.0 + gs - 2.0 * gs * u1)
    cos_hg = (1.0 + gs * gs - sqr * sqr) / (2.0 * gs)
    cos_theta = torch.where(safe, cos_hg, 1.0 - 2.0 * u1)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    wo = _from_cos_theta(wi, cos_theta, u2)
    pdf = torch.where(safe, hg_phase(cos_theta, g), INV_4PI)
    return wo, pdf


def sample_schlick(wi: Tensor, k, u1: Tensor, u2: Tensor):
    k = _scalar(k, u1)
    safe = torch.abs(k) > 1e-3
    ks = torch.where(safe, k, 1.0)
    cos_sl = (2.0 * u1 + ks - 1.0) / (2.0 * ks * u1 - ks + 1.0)
    cos_theta = torch.where(safe, cos_sl, 1.0 - 2.0 * u1)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    wo = _from_cos_theta(wi, cos_theta, u2)
    pdf = torch.where(safe, schlick_phase(cos_theta, k), INV_4PI)
    return wo, pdf


def sample_phase(phase_type: int, wi: Tensor, g, u1: Tensor, u2: Tensor):
    """Dispatch on a static phase type."""
    if phase_type == ISOTROPIC:
        return sample_isotropic(wi, u1, u2)
    if phase_type == HENYEY_GREENSTEIN:
        return sample_hg(wi, g, u1, u2)
    if phase_type == SCHLICK:
        return sample_schlick(wi, g, u1, u2)
    raise ValueError(f"unknown phase type {phase_type}")

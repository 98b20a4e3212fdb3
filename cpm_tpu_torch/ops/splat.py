"""Photon splatting into the light volume (``cpm_tpu/ops/splat.py``).

Backends: "scatter" is the exact radial-Epanechnikov scatter-add
(reference parity, ``index_add_``); "matmul" is the plain PyTorch version
of the separable product kernel; "cuda" is the product kernel's wrapper,
which launches the hand-written Hopper kernel for CUDA tensors. "auto"
picks by the device of the tensors (:func:`default_method`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpm_tpu_torch.core import constants
from cpm_tpu_torch.core.types import PhotonData, relative_irradiance_scale
from cpm_tpu_torch.kernels.splat_product import (PRODUCT_KERNEL_MATCH,
                                                 splat_product,
                                                 splat_product_torch)

Tensor = torch.Tensor

__all__ = ["PRODUCT_KERNEL_MATCH", "default_method", "epanechnikov",
           "light_volume_dim", "product_deposits", "splat_all",
           "splat_product_torch"]


def epanechnikov(x: Tensor) -> Tensor:
    """0.75*(1 - x^2) for x <= 1 else 0."""
    return torch.where(x <= 1.0, 0.75 * (1.0 - x * x), 0.0)


def default_method(device: torch.device) -> str:
    """The product kernel for tensors on a CUDA device, its plain version
    for CPU tensors."""
    return "cuda" if torch.device(device).type == "cuda" else "matmul"


def light_volume_dim(radius_rel: float) -> int:
    """Output size ceil(1/r_rel) per axis."""
    return int(math.ceil(1.0 / radius_rel))


def _splat_flat(positions: Tensor, powers: Tensor, valid: Tensor,
                radius_rel: float, scale: float, out_dim: tuple,
                footprint: int) -> Tensor:
    """Scatter-add a flat list of photons into a (D, H, W, 3) grid with the
    radial kernel over each photon's voxel AABB
    (``cpm_tpu/ops/splat.py:97-154``)."""
    d, h, w = out_dim
    dev = positions.device
    dims = torch.tensor([w, h, d], dtype=torch.float32, device=dev)
    hi = torch.tensor([w, h, d], dtype=torch.int64, device=dev)
    f = footprint
    r = radius_rel
    # Unused slots sit at FLT_MAX; park them at 0 so the int casts stay
    # defined (they are masked out below).
    pos = torch.where(valid[:, None], positions, 0.0)

    # Voxel AABB of the photon sphere (truncation toward zero).
    start = torch.clamp(torch.trunc((pos - r) * dims - 0.5).to(torch.int64),
                        min=0)
    end = torch.minimum(
        torch.trunc((pos + r) * dims - 0.5).to(torch.int64) + 1, hi)

    f3 = f * f * f
    k = torch.arange(f3, device=dev)
    oz, oy, ox = k // (f * f), (k // f) % f, k % f
    cx = start[:, 0:1] + ox[None, :]  # (n, f^3)
    cy = start[:, 1:2] + oy[None, :]
    cz = start[:, 2:3] + oz[None, :]
    inside = ((cx < end[:, 0:1]) & (cy < end[:, 1:2]) & (cz < end[:, 2:3])
              & valid[:, None])

    dx = (cx.to(torch.float32) + 0.5) / w - pos[:, 0:1]
    dy = (cy.to(torch.float32) + 0.5) / h - pos[:, 1:2]
    dz = (cz.to(torch.float32) + 0.5) / d - pos[:, 2:3]
    weight = epanechnikov(torch.sqrt(dx * dx + dy * dy + dz * dz) / r)
    weight = torch.where(inside, weight, 0.0)

    cell = torch.where(inside, cz * (w * h) + cy * w + cx, d * h * w)
    contrib = weight[:, None, :] * (powers * scale)[:, :, None]  # (n, 3, f^3)
    cell3 = cell[:, None, :] * 3 + torch.arange(3, device=dev)[None, :, None]
    g = torch.zeros(d * h * w * 3 + 3, dtype=torch.float32, device=dev)
    g.index_add_(0, cell3.reshape(-1), contrib.reshape(-1))
    return g[:d * h * w * 3].reshape(d, h, w, 3)


def _flatten(photons: PhotonData):
    """(positions (M, 3), powers (M, 3), valid (M,), irradiance scale) of
    every stored photon, interaction-major."""
    i, n, _ = photons.positions.shape
    pos = photons.positions.reshape(i * n, 3)
    pow_ = photons.powers.reshape(i * n, 3)
    valid = pos[:, 0] < 1e30
    scale = float(np.float32(constants.ISOTROPIC_PHASE) * np.float32(
        relative_irradiance_scale(n, photons.radius_rel)))
    return pos, pow_, valid, scale


def _product_powers(pow_: Tensor, valid: Tensor, scale: float) -> Tensor:
    """Powers as the product kernel takes them: masked, and scaled by
    PRODUCT_KERNEL_MATCH so both kernels deposit the same expected
    irradiance."""
    factor = float(np.float32(scale) * np.float32(PRODUCT_KERNEL_MATCH))
    return pow_ * factor * valid[:, None].to(torch.float32)


def product_deposits(photons: PhotonData) -> tuple[Tensor, Tensor]:
    """The contiguous (positions, powers) that ``splat_all`` hands
    ``splat_product`` for these photons."""
    pos, pow_, valid, scale = _flatten(photons)
    return pos.contiguous(), _product_powers(pow_, valid, scale).contiguous()


def splat_all(photons: PhotonData, out_dim: tuple, footprint: int = 4,
              method: str = "scatter") -> Tensor:
    """Splat every stored photon into a (D, H, W, 3) RGB irradiance grid
    scaled by isotropicPhase * relativeIrradianceScale."""
    if method == "auto":
        method = default_method(photons.positions.device)
    if method == "scatter":
        pos, pow_, valid, scale = _flatten(photons)
        return _splat_flat(pos, pow_, valid, photons.radius_rel, scale,
                           out_dim, footprint)
    if method == "matmul":
        return splat_product_torch(*product_deposits(photons),
                                   photons.radius_rel, out_dim)
    if method == "cuda":
        return splat_product(*product_deposits(photons), photons.radius_rel,
                             out_dim)
    raise ValueError(f"unknown splat method {method!r}")

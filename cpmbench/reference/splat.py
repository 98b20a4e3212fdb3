"""The splat's plain form, frozen: each stored photon deposits its power
into the (D, H, W, 3) light volume through the separable product of three
Epanechnikov profiles, as a dense contraction per chunk of deposits in full
float32, scaled by isotropicPhase * relativeIrradianceScale(N, radius).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpmbench.reference import constants
from cpmbench.reference.types import PhotonData, relative_irradiance_scale

Tensor = torch.Tensor

# Ratio of the radial Epanechnikov mass (2*pi*r^3/5) to the product kernel
# mass (r^3), so both deposit the same expected irradiance.
PRODUCT_KERNEL_MATCH = 0.4 * math.pi


def light_volume_dim(radius_rel: float) -> int:
    """Output size ceil(1/r_rel) per axis."""
    return int(math.ceil(1.0 / radius_rel))


def inverse_radius(radius_rel: float) -> np.float32:
    """1 / r in float32."""
    return np.float32(1.0) / np.float32(radius_rel)


def voxel_centres(n: int, device) -> Tensor:
    """(i + 0.5) / n for i < n, each a correctly rounded float32 division,
    made on the host (a CUDA tensor divided by a Python number is
    multiplied by the rounded reciprocal instead)."""
    c = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    return torch.from_numpy(c).to(device)


def _axis_kernels(positions: Tensor, inv_r: float, centres: tuple):
    """(Kz, Ky, Kx): each deposit's weight at every cell centre of each
    axis, (M, D), (M, H), (M, W)."""
    def kern(c, p):
        dist = (c[None, :] - p[:, None]) * inv_r
        return torch.clamp(0.75 * (1.0 - dist * dist), min=0.0)

    zc, yc, xc = centres
    return (kern(zc, positions[:, 2]), kern(yc, positions[:, 1]),
            kern(xc, positions[:, 0]))


def splat_product(positions: Tensor, powers: Tensor, radius_rel: float,
                  out_dim: tuple, chunk: int = 16384) -> Tensor:
    """The separable kernel as a dense contraction per chunk of deposits;
    ``powers`` already carry the scale and validity mask."""
    d, h, w = out_dim
    inv_r = float(inverse_radius(radius_rel))
    centres = tuple(voxel_centres(n, positions.device) for n in out_dim)
    acc = torch.zeros((d * h, w * 3), dtype=torch.float32,
                      device=positions.device)
    for lo in range(0, positions.shape[0], chunk):
        kz, ky, kx = _axis_kernels(positions[lo:lo + chunk], inv_r, centres)
        a = (kz[:, :, None] * ky[:, None, :]).reshape(-1, d * h)
        b = (kx[:, :, None] * powers[lo:lo + chunk, None, :]).reshape(
            -1, w * 3)
        acc.addmm_(a.T, b)
    return acc.reshape(d, h, w, 3)


def irradiance_scale(photons: PhotonData) -> float:
    """isotropicPhase * relativeIrradianceScale(N, radius), in float32."""
    return float(np.float32(constants.ISOTROPIC_PHASE) * np.float32(
        relative_irradiance_scale(photons.n, photons.radius_rel)))


def _deposits(pos: Tensor, pow_: Tensor, valid: Tensor, scale: float):
    factor = float(np.float32(scale) * np.float32(PRODUCT_KERNEL_MATCH))
    powers = pow_ * factor * valid[:, None].to(torch.float32)
    return pos.contiguous(), powers.contiguous()


def splat_all(photons: PhotonData, out_dim: tuple) -> Tensor:
    """Splat every stored photon (unused slots hold FLT_MAX positions)."""
    i, n, _ = photons.positions.shape
    pos = photons.positions.reshape(i * n, 3).to(torch.float32)
    pow_ = photons.powers.reshape(i * n, 3).to(torch.float32)
    return splat_product(*_deposits(pos, pow_, pos[:, 0] < 1e30,
                                    irradiance_scale(photons)),
                         photons.radius_rel, out_dim)


def splat_selected(photons: PhotonData, indices: Tensor, valid: Tensor,
                   out_dim: tuple) -> Tensor:
    """Splat only the photons whose light-sample ids are in ``indices``;
    ``valid`` masks budget padding lanes."""
    i = photons.max_interactions
    b = indices.shape[0]
    safe = torch.where(valid, indices, 0)
    pos = photons.positions[:, safe].reshape(i * b, 3).to(torch.float32)
    pow_ = photons.powers[:, safe].reshape(i * b, 3).to(torch.float32)
    lane_valid = valid[None, :].expand(i, b).reshape(i * b)
    return splat_product(*_deposits(pos, pow_, lane_valid & (pos[:, 0] < 1e30),
                                    irradiance_scale(photons)),
                         photons.radius_rel, out_dim)

"""Photon splatting into the light volume (``cpm_tpu/ops/splat.py``).

Backends: "scatter" is the exact radial-Epanechnikov scatter-add
(reference parity, ``index_add_``); "matmul" is the plain PyTorch version
of the separable product kernel; "cuda" is the product kernel's wrapper,
which launches the hand-written Hopper kernel for CUDA tensors, through
``SplatProduct``, so that it is differentiable with respect to the powers
(its backward is a kernel too). "auto" picks by the device of the tensors
(:func:`default_method`).

:func:`splat_all` splats every stored photon; :func:`splat_selected` and
:func:`splat_selected_delta` splat the photons of a retrace batch, the
latter as one signed list (-old, +new), which is one kernel launch per
correlated step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpm_tpu_torch.core import constants, telemetry
from cpm_tpu_torch.core.types import PhotonData, relative_irradiance_scale
from cpm_tpu_torch.kernels.splat_product import (PRODUCT_KERNEL_MATCH,
                                                 SplatProduct,
                                                 splat_product_torch)

Tensor = torch.Tensor

__all__ = ["PRODUCT_KERNEL_MATCH", "default_method", "delta_deposits",
           "epanechnikov", "light_volume_dim", "product_deposits",
           "splat_all", "splat_product_torch", "splat_selected",
           "splat_selected_delta"]


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


def _irradiance_scale(photons: PhotonData, multiplier: float = 1.0,
                      n_total: int | None = None) -> float:
    """isotropicPhase * relativeIrradianceScale(N, radius) * multiplier, in
    float32. N, the photon count the irradiance is normalized by, is
    ``photons.n`` unless ``n_total`` is given: a shard of the light samples
    splats its photons with the count of the whole map, so that the sum of
    the shards' grids is the grid of all the photons."""
    n = photons.n if n_total is None else n_total
    return float(np.float32(constants.ISOTROPIC_PHASE) * np.float32(
        relative_irradiance_scale(n, photons.radius_rel))
        * np.float32(multiplier))


def _flatten(photons: PhotonData, n_total: int | None = None):
    """(positions (M, 3), powers (M, 3), valid (M,), irradiance scale) of
    every stored photon, interaction-major, in float32 whatever the
    photons' storage type (a float16 sentinel is +inf); the scale
    normalizes by ``n_total`` photons where it is given."""
    i, n, _ = photons.positions.shape
    pos = photons.positions.reshape(i * n, 3).to(torch.float32)
    pow_ = photons.powers.reshape(i * n, 3).to(torch.float32)
    return (pos, pow_, pos[:, 0] < 1e30,
            _irradiance_scale(photons, n_total=n_total))


def _flatten_selected(photons: PhotonData, indices: Tensor, valid: Tensor):
    """(positions (I*B, 3), powers (I*B, 3), valid (I*B,)) of the photons
    whose light-sample ids are ``indices``, in float32. A padding lane
    (``valid`` False) reads photon 0 and is masked out."""
    i = photons.max_interactions
    b = indices.shape[0]
    safe = torch.where(valid, indices, 0)
    pos = photons.positions[:, safe].reshape(i * b, 3).to(torch.float32)
    pow_ = photons.powers[:, safe].reshape(i * b, 3).to(torch.float32)
    lane_valid = valid[None, :].expand(i, b).reshape(i * b)
    return pos, pow_, lane_valid & (pos[:, 0] < 1e30)


def _product_list(pos: Tensor, pow_: Tensor, valid: Tensor,
                  scale: float) -> tuple[Tensor, Tensor]:
    """A deposit list as the product kernel takes it: contiguous positions,
    and powers masked and scaled by PRODUCT_KERNEL_MATCH so both kernels
    deposit the same expected irradiance."""
    factor = float(np.float32(scale) * np.float32(PRODUCT_KERNEL_MATCH))
    powers = pow_ * factor * valid[:, None].to(torch.float32)
    return pos.contiguous(), powers.contiguous()


def product_deposits(photons: PhotonData,
                     n_total: int | None = None) -> tuple[Tensor, Tensor]:
    """The (positions, powers) that ``splat_all`` hands ``splat_product``
    for these photons (with the same ``n_total``)."""
    return _product_list(*_flatten(photons, n_total))


def _signed_selected(old: PhotonData, new: PhotonData, indices: Tensor,
                     valid: Tensor):
    """The selected photons' old deposits with their powers negated, then
    their new ones: (positions, powers, valid), 2*I*B of each."""
    old_pos, old_pow, old_valid = _flatten_selected(old, indices, valid)
    new_pos, new_pow, new_valid = _flatten_selected(new, indices, valid)
    return (torch.cat([old_pos, new_pos]), torch.cat([-old_pow, new_pow]),
            torch.cat([old_valid, new_valid]))


def delta_deposits(old: PhotonData, new: PhotonData, indices: Tensor,
                   valid: Tensor) -> tuple[Tensor, Tensor]:
    """The (positions, powers), 2*I*B of each, that
    ``splat_selected_delta`` hands ``splat_product`` for this batch."""
    return _product_list(*_signed_selected(old, new, indices, valid),
                         _irradiance_scale(old))


def _dispatch(method: str, pos: Tensor, pow_: Tensor, valid: Tensor,
              radius_rel: float, scale: float, out_dim: tuple,
              footprint: int) -> Tensor:
    """Route a flat photon list to a splat backend (see the module doc)."""
    if method == "auto":
        method = default_method(pos.device)
    if method == "scatter":
        return _splat_flat(pos, pow_, valid, radius_rel, scale, out_dim,
                           footprint)
    if method not in ("matmul", "cuda"):
        raise ValueError(f"unknown splat method {method!r}")
    fn = splat_product_torch if method == "matmul" else SplatProduct.apply
    with telemetry.span("splat.product_list"):
        deposits = _product_list(pos, pow_, valid, scale)
    return fn(*deposits, radius_rel, out_dim)


@telemetry.spanned("splat.all")
def splat_all(photons: PhotonData, out_dim: tuple, footprint: int = 4,
              n_total: int | None = None,
              method: str = "scatter") -> Tensor:
    """Splat every stored photon into a (D, H, W, 3) RGB irradiance grid
    scaled by isotropicPhase * relativeIrradianceScale(N, radius).
    ``n_total`` overrides N, which is ``photons.n`` by default: the
    parallel layer passes the global photon count when each rank splats
    only its slice of the photons, so that the ranks' grids sum to the
    single-device grid. The scale is applied to the powers before the
    backend (and the CUDA kernel's wrapper) sees them."""
    with telemetry.span("splat.deposits"):
        pos, pow_, valid, scale = _flatten(photons, n_total)
    return _dispatch(method, pos, pow_, valid, photons.radius_rel, scale,
                     out_dim, footprint)


@telemetry.spanned("splat.selected_delta")
def splat_selected_delta(old: PhotonData, new: PhotonData, indices: Tensor,
                         valid: Tensor, out_dim: tuple, footprint: int = 4,
                         method: str = "scatter") -> Tensor:
    """The incremental -old/+new update in one splat pass: the selected
    photons' old deposits (weight -1) and new deposits (weight +1) as one
    signed list. Returns the light-volume delta, to be added to the
    previous volume. ``valid`` masks budget padding lanes."""
    with telemetry.span("splat.deposits"):
        pos, pow_, pvalid = _signed_selected(old, new, indices, valid)
    return _dispatch(method, pos, pow_, pvalid, old.radius_rel,
                     _irradiance_scale(old), out_dim, footprint)


@telemetry.spanned("splat.selected")
def splat_selected(photons: PhotonData, indices: Tensor, valid: Tensor,
                   out_dim: tuple, footprint: int = 4,
                   multiplier: float = 1.0,
                   method: str = "scatter") -> Tensor:
    """Splat only the photons whose light-sample ids are in ``indices``,
    scaled by ``multiplier``: -1 removes a photon's previous contribution,
    +1 adds the retraced one. ``valid`` masks budget padding lanes."""
    with telemetry.span("splat.deposits"):
        pos, pow_, pvalid = _flatten_selected(photons, indices, valid)
    return _dispatch(method, pos, pow_, pvalid, photons.radius_rel,
                     _irradiance_scale(photons, multiplier), out_dim,
                     footprint)

"""Pipeline state (``cpm_tpu/pipeline/state.py:PhotonMapState``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cpm_tpu_torch.core.types import LightSamples, PhotonData

Tensor = torch.Tensor


@dataclass
class PhotonMapState:
    """Progressive photon-mapping state: photon buffer, light samples and
    light volumes. ``key`` is the (k0, k1) threefry key of the stream root,
    word for word the reference's ``jax.random.PRNGKey`` data."""

    photons: PhotonData
    light_samples: LightSamples
    light_volume: Tensor  # (D, H, W, 3) current-iteration irradiance
    light_volume_accum: Tensor  # (D, H, W, 3) progressive average
    key: tuple  # (k0, k1) uint32 words as Python ints
    retraced: Tensor  # (N,) bool
    n_remaining: int = 0
    recompute_phase: int = 0
    prev_minmax: Tensor | None = None

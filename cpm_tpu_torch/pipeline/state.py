"""Pipeline state and dirty flags (``cpm_tpu/pipeline/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cpm_tpu_torch.core.types import LightSamples, PhotonData

Tensor = torch.Tensor


@dataclass(frozen=True)
class DirtyFlags:
    """What changed since the last step."""

    light: bool = False
    camera: bool = False
    tf: bool = False
    volume: bool = False
    progressive: bool = False

    @property
    def resets_iteration(self) -> bool:
        """Any of light/camera/TF/volume (or nothing at all) restarts the
        progressive iteration."""
        return (self.light or self.camera or self.tf or self.volume
                or not self.progressive)

    @property
    def any(self) -> bool:
        return (self.light or self.camera or self.tf or self.volume
                or self.progressive)


ALL_DIRTY = DirtyFlags(light=True, camera=True, tf=True, volume=True)


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
    retraced: Tensor  # (N,) bool: already retraced in this drain round
    n_remaining: int = 0  # flagged photons not yet retraced
    # Equal-importance round-robin phase, advanced once per correlated
    # step and not reset by invalidations.
    recompute_phase: int = 0
    prev_minmax: Tensor | None = None

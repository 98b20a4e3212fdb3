"""Scene container: everything the pipeline consumes
(``cpm_tpu/core/scene.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.types import TransferFunction, Volume


@dataclass
class Scene:
    volume: Volume
    tf: TransferFunction
    tf_scattering: TransferFunction
    camera: Camera
    # Host-side :class:`cpm_tpu_torch.core.lights.Light` objects (the
    # light-plane fit runs on the host).
    lights: Any = ()

    @property
    def device(self):
        return self.volume.device

    @classmethod
    def create(cls, volume: Volume, tf: TransferFunction,
               tf_scattering: TransferFunction, lights: Sequence,
               camera: Camera | None = None) -> "Scene":
        if camera is None:
            camera = Camera.create(device=volume.device)
        return cls(volume=volume, tf=tf, tf_scattering=tf_scattering,
                   camera=camera, lights=tuple(lights))

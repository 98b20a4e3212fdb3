"""Pinhole camera (``cpm_tpu/core/camera.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.device import resolve

Tensor = torch.Tensor


@dataclass
class Camera:
    eye: Tensor  # (3,) texture-space position
    center: Tensor  # (3,) look-at point
    up: Tensor  # (3,)
    fov_y: float  # degrees, float32 value

    @classmethod
    @telemetry.spanned("scene.camera")
    def create(cls, eye=(0.5, 0.5, -1.5), center=(0.5, 0.5, 0.5),
               up=(0.0, 1.0, 0.0), fov_y=45.0, device=None) -> "Camera":
        dev = resolve(device)

        def vec(v):
            return telemetry.wait("camera.create", torch.as_tensor,
                                  np.asarray(v, np.float32), device=dev)

        return cls(eye=vec(eye), center=vec(center), up=vec(up),
                   fov_y=float(np.float32(fov_y)))

    def rays(self, width: int, height: int):
        """Per-pixel ray origins and directions, (H, W, 3) each."""
        dev = self.eye.device
        fwd = self.center - self.eye
        fwd = fwd / torch.linalg.vector_norm(fwd)
        right = torch.linalg.cross(fwd, self.up)
        right = right / torch.linalg.vector_norm(right)
        up = torch.linalg.cross(right, fwd)

        aspect = width / height
        fov = telemetry.wait("camera.fov", torch.tensor, self.fov_y,
                             dtype=torch.float32, device=dev)
        tan_half = torch.tan(torch.deg2rad(fov) * 0.5)
        ys = (torch.arange(height, dtype=torch.float32, device=dev)
              + 0.5) / height
        xs = (torch.arange(width, dtype=torch.float32, device=dev)
              + 0.5) / width
        px = (2.0 * xs - 1.0) * tan_half * aspect
        py = (1.0 - 2.0 * ys) * tan_half
        d = (fwd[None, None, :]
             + right[None, None, :] * px[None, :, None]
             + up[None, None, :] * py[:, None, None])
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        o = self.eye.expand(d.shape)
        return o, d

    def host(self, name: str) -> np.ndarray:
        """A field as a float32 numpy array (camera setup is host work)."""
        return telemetry.wait("camera.host", torch.Tensor.cpu,
                              getattr(self, name).detach()).numpy()

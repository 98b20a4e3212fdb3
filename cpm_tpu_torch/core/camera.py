"""Pinhole camera (``cpm_tpu/core/camera.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.device import resolve

Tensor = torch.Tensor

_VECTORS = ("eye", "center", "up")


class _Made(NamedTuple):
    """What a camera was made with: its eye, center and up tensors and
    their versions, their float32 host copies (name -> array), its fov_y
    and that fov on the device, a () float32 tensor."""

    tensors: tuple
    versions: tuple
    host: dict
    fov_y: float
    fov: Tensor


@dataclass
class Camera:
    eye: Tensor  # (3,) texture-space position
    center: Tensor  # (3,) look-at point
    up: Tensor  # (3,)
    fov_y: float  # degrees, float32 value
    # Host copies of the vectors and the fov on the device, kept by
    # ``create``; read while the fields are the tensors it made, unchanged,
    # and the same fov_y. A camera built any other way reads the card.
    made: _Made | None = field(default=None, repr=False, compare=False)

    @classmethod
    @telemetry.spanned("scene.camera")
    def create(cls, eye=(0.5, 0.5, -1.5), center=(0.5, 0.5, 0.5),
               up=(0.0, 1.0, 0.0), fov_y=45.0, device=None) -> "Camera":
        host = {name: np.array(v, np.float32)
                for name, v in zip(_VECTORS, (eye, center, up))}
        fov_y = float(np.float32(fov_y))
        # One upload: the three vectors and the fov, as views of it.
        flat = telemetry.wait(
            "camera.create", torch.as_tensor,
            np.concatenate([*host.values(), [np.float32(fov_y)]]),
            device=resolve(device))
        return cls.of(flat[0:3], flat[3:6], flat[6:9], flat[9], fov_y, host)

    @classmethod
    def of(cls, eye: Tensor, center: Tensor, up: Tensor, fov: Tensor,
           fov_y: float, host: dict) -> "Camera":
        """A camera on device tensors that hold ``host``'s vectors (name ->
        float32 array) and ``fov_y`` (``fov``, a () float32 tensor), which
        it keeps as what it was made with."""
        tensors = (eye, center, up)
        return cls(eye=eye, center=center, up=up, fov_y=fov_y, made=_Made(
            tensors, tuple(t._version for t in tensors), dict(host), fov_y,
            fov))

    def _made(self) -> _Made | None:
        """What the camera was made with, where its fields still hold it."""
        m = self.made
        if m is None or m.fov_y != self.fov_y:
            return None
        for name, t, version in zip(_VECTORS, m.tensors, m.versions):
            if getattr(self, name) is not t or t._version != version:
                return None
        return m

    def fov(self) -> Tensor:
        """fov_y as a () float32 tensor on the camera's device: the one it
        was made with, else uploaded."""
        m = self._made()
        if m is not None:
            return m.fov
        return telemetry.wait("camera.fov", torch.tensor, self.fov_y,
                              dtype=torch.float32, device=self.eye.device)

    def rays(self, width: int, height: int):
        """Per-pixel ray origins and directions, (H, W, 3) each."""
        dev = self.eye.device
        fwd = self.center - self.eye
        fwd = fwd / torch.linalg.vector_norm(fwd)
        right = torch.linalg.cross(fwd, self.up)
        right = right / torch.linalg.vector_norm(right)
        up = torch.linalg.cross(right, fwd)

        aspect = width / height
        tan_half = torch.tan(torch.deg2rad(self.fov()) * 0.5)
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
        """A field as a float32 numpy array (camera setup is host work):
        the host copy the camera was made with, else read from the card."""
        m = self._made()
        if m is not None:
            return m.host[name].copy()
        return telemetry.wait("camera.host", torch.Tensor.cpu,
                              getattr(self, name).detach()).numpy()

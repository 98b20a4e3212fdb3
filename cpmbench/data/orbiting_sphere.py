"""The time-varying sequence of BASELINE config 4, the shape of the port's
``io/synthetic.time_varying_sequence`` (a soft sphere, ``sphere_in_box``,
orbiting the box's centre with a pulsating radius), written again in
PyTorch and made on the device: ``{"kind": "orbiting_sphere", "dim": D,
"steps": T}``. It draws nothing from the seed.

:func:`make` gives step 0, the volume the set-up traces; :func:`sequence`
gives all ``T`` steps, (T, D, H, W) float32 in [0, 1]."""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

SOFT = 0.05  # the width of the sphere's edge


def step(dim: int, t: int, steps: int, device=None) -> Tensor:
    """Step ``t`` of ``steps``: the sphere centred at (0.5 + 0.22 cos a,
    0.5 + 0.22 sin a, 0.5), a = 2 pi t / steps, of radius 0.18 + 0.05
    sin 2a, its density clip((radius - r) / 0.05 + 0.5, 0, 1) at the voxel
    centres, computed in float64 and stored in float32."""
    ang = 2 * np.pi * t / steps
    cx, cy = 0.5 + 0.22 * np.cos(ang), 0.5 + 0.22 * np.sin(ang)
    radius = 0.18 + 0.05 * np.sin(2 * ang)
    c = (torch.arange(dim, dtype=torch.float64, device=device) + 0.5) / dim
    r = torch.sqrt((c[None, None, :] - cx) ** 2 + (c[None, :, None] - cy) ** 2
                   + (c[:, None, None] - 0.5) ** 2)
    return torch.clamp((radius - r) / SOFT + 0.5, 0.0, 1.0).to(torch.float32)


def sequence(spec: dict, generator: torch.Generator, device) -> Tensor:
    steps = spec["steps"]
    return torch.stack([step(spec["dim"], t, steps, device=device)
                        for t in range(steps)])


def make(spec: dict, generator: torch.Generator, device) -> Tensor:
    return step(spec["dim"], 0, spec["steps"], device=device)

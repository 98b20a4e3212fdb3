"""The CT-head phantom of BASELINE config 3, the shape of the port's
``io/synthetic.ct_head_like`` (its shells), written again in PyTorch and
made on the device: ``{"kind": "ct_head_like", "dim": D}``. It draws
nothing from the seed."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def ct_head_like(dim: int, device=None) -> Tensor:
    """CT-head-like phantom in [0, 1], (dim, dim, dim) float32: a thin
    dense ellipsoid shell (skull) around a medium-density interior (soft
    tissue) with a brighter core, on an empty background."""
    t = torch.arange(dim, dtype=torch.float32, device=device) / dim
    z, y, x = t[:, None, None], t[None, :, None], t[None, None, :]
    r = torch.sqrt(((x - 0.5) / 0.32) ** 2 + ((y - 0.5) / 0.38) ** 2
                   + ((z - 0.5) / 0.42) ** 2)
    skull = torch.clamp(1.0 - torch.abs(r - 0.92) / 0.08, 0.0, 1.0)
    tissue = torch.where(r < 0.88, 0.35, 0.0)
    core = torch.clamp(0.6 - torch.sqrt((x - 0.55) ** 2 + (y - 0.5) ** 2
                                        + (z - 0.45) ** 2) / 0.2, 0.0, 0.6)
    return torch.clamp(0.9 * skull + tissue + core, 0.0, 1.0)


def make(spec: dict, generator: torch.Generator, device) -> Tensor:
    return ct_head_like(spec["dim"], device=device)

"""The fractal smoke cloud of BASELINE configs 2 and 5, the shape of the
port's ``io/synthetic.smoke_cloud`` (its octaves and falloff), written
again in PyTorch and made on the device from the run's seed:
``{"kind": "smoke_cloud", "dim": D, "octaves": K}``."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _upsample_axis(a: Tensor, axis: int, dim: int) -> Tensor:
    """Linear upsampling of ``a`` along ``axis`` to ``dim`` samples at
    ``linspace(0, n - 1, dim)`` (the ends on the first and last sample)."""
    n = a.shape[axis]
    idx = torch.linspace(0, n - 1, dim, dtype=torch.float64,
                         device=a.device)
    i0 = torch.floor(idx).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = (idx - i0).to(torch.float32)
    shape = [1, 1, 1]
    shape[axis] = dim
    a0 = a.index_select(axis, i0)
    a1 = a.index_select(axis, i1)
    return a0 + (a1 - a0) * f.reshape(shape)


def smoke_cloud(dim: int, generator: torch.Generator, octaves: int = 4,
                device=None) -> Tensor:
    """Fractal value-noise cloud in [0, 1], (dim, dim, dim) float32: per
    octave a coarse grid of uniforms from ``generator``, upsampled
    trilinearly, weighted 1, 1/2, 1/4, ...; then clipped to (acc - 0.4) *
    2.5 and carved by a radial falloff 1 - 2.2 r."""
    acc = torch.zeros((dim, dim, dim), dtype=torch.float32, device=device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        n = max(2, dim >> (octaves - 1 - o + 2))
        coarse = torch.rand((n, n, n), generator=generator,
                            dtype=torch.float32, device=device)
        up = coarse
        for axis in range(3):
            up = _upsample_axis(up, axis, dim)
        acc += amp * up
        total += amp
        amp *= 0.5
    acc /= total
    c2 = ((torch.arange(dim, dtype=torch.float32, device=device) + 0.5)
          / dim - 0.5) ** 2
    falloff = torch.clamp(1.0 - 2.2 * torch.sqrt(
        c2[None, None, :] + c2[None, :, None] + c2[:, None, None]), 0, 1)
    return torch.clamp((acc - 0.4) * 2.5, 0, 1) * falloff


def make(spec: dict, generator: torch.Generator, device) -> Tensor:
    return smoke_cloud(spec["dim"], generator, spec.get("octaves", 4),
                       device=device)

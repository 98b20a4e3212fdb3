"""Volume sampling and the deterministic sample grid
(``cpm_tpu/ops/sampling.py``: ``stratified_grid_2d`` :248-267,
``sample_volume_trilinear`` :54-74).

On a GPU a trilinear fetch is eight plain gathers; the reference's packed
brick rows exist only because a TPU gather costs per index.
"""

from __future__ import annotations

import torch

from cpm_tpu_torch.core.device import resolve

Tensor = torch.Tensor


def stratified_grid_2d(nx: int, ny: int, device=None) -> Tensor:
    """(nx*ny, 4) samples (u, v, 0, pdf=1) at the cell centres of an nx x ny
    grid, x fastest."""
    device = resolve(device)
    ix = torch.arange(nx, dtype=torch.float32, device=device)
    iy = torch.arange(ny, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(iy, ix, indexing="ij")
    u = (gx + 0.5) / nx
    v = (gy + 0.5) / ny
    n = nx * ny
    return torch.stack([u.reshape(-1), v.reshape(-1),
                        torch.zeros(n, device=device),
                        torch.ones(n, device=device)], dim=-1)


def voxel_coords(shape_zyx, pos: Tensor) -> Tensor:
    """Continuous voxel coordinates clamped to [0, dim-1] (CLAMP_TO_EDGE),
    (..., 3) in (x, y, z) order."""
    d, h, w = shape_zyx
    dims = torch.tensor([w, h, d], dtype=torch.float32, device=pos.device)
    return torch.clamp(pos * dims - 0.5, min=torch.zeros_like(dims),
                       max=dims - 1.0)


def sample_volume_trilinear(data: Tensor, pos: Tensor) -> Tensor:
    """Trilinear fetch from a (D, H, W) volume at texture coordinates
    (..., 3) = (x, y, z); voxel centres at (i+0.5)/dim, edge-clamped."""
    d, h, w = data.shape
    cf = voxel_coords((d, h, w), pos)
    c0f = torch.floor(cf)
    frac = cf - c0f
    c0 = c0f.to(torch.int64)
    c1 = torch.minimum(c0 + 1, torch.tensor([w - 1, h - 1, d - 1],
                                            device=pos.device))
    flat = data.reshape(-1)
    acc = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    for dz, cz in ((0, c0[..., 2]), (1, c1[..., 2])):
        wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
        for dy, cy in ((0, c0[..., 1]), (1, c1[..., 1])):
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            base = (cz * h + cy) * w
            for dx, cx in ((0, c0[..., 0]), (1, c1[..., 0])):
                wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
                acc = acc + flat[base + cx] * (wx * wy * wz)
    return acc

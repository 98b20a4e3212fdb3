"""Volume sampling, the stratified sample grid, its Hilbert order and the
guided-emission warp (``cpm_tpu/ops/sampling.py``: ``stratified_grid_2d``
:248-267, ``hilbert_index_2d`` :270-292, ``warp_samples_2d`` :295-348,
``sample_volume_trilinear`` :54-74, ``sample_volume_trilinear_vec``
:77-100).

On a GPU a trilinear fetch is eight plain gathers; the reference's packed
brick rows exist only because a TPU gather costs per index.
"""

from __future__ import annotations

import torch

from cpmbench.reference.device import resolve
from cpmbench.reference import rng

Tensor = torch.Tensor


def stratified_grid_2d(nx: int, ny: int, key=None, device=None) -> Tensor:
    """(nx*ny, 4) samples (u, v, 0, pdf=1) on an nx x ny grid, x fastest:
    at the cell centres, or jittered inside each cell when a (k0, k1)
    ``key`` is given (the draws of ``jax.random.split`` and ``uniform``)."""
    device = resolve(device)
    ix = torch.arange(nx, dtype=torch.float32, device=device)
    iy = torch.arange(ny, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(iy, ix, indexing="ij")
    if key is None:
        ju = jv = 0.5
    else:
        k1, k2 = rng.split(key)
        ju = rng.uniform(k1, gx.shape, device)
        jv = rng.uniform(k2, gy.shape, device)
    u = (gx + ju) / nx
    v = (gy + jv) / ny
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


def _take(flat: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``flat`` at any shape of indices, through ``index_select``:
    its backward adds with ``index_add_``, where advanced indexing's sorts
    the indices and walks each one's duplicates in a single warp on a card,
    and the unused slots of a replay or an event tape all read one voxel
    (3.7 s of a 4.8 s gradient at the default frame on an H100)."""
    return flat.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *flat.shape[1:])


def _trilinear(flat: Tensor, shape_zyx, pos: Tensor) -> Tensor:
    """The weighted sum of the eight edge-clamped corner entries of
    ``flat`` (in z, y, x order) around each position: (...,) from a scalar
    table, (..., C) from rows of C."""
    d, h, w = shape_zyx
    cf = voxel_coords(shape_zyx, pos)
    c0f = torch.floor(cf)
    frac = cf - c0f
    c0 = c0f.to(torch.int64)
    c1 = torch.minimum(c0 + 1, torch.tensor([w - 1, h - 1, d - 1],
                                            device=pos.device))
    rows = flat.dim() == 2
    acc = 0.0
    for dz, cz in ((0, c0[..., 2]), (1, c1[..., 2])):
        wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
        for dy, cy in ((0, c0[..., 1]), (1, c1[..., 1])):
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            base = (cz * h + cy) * w
            for dx, cx in ((0, c0[..., 0]), (1, c1[..., 0])):
                wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
                wgt = wx * wy * wz
                acc = acc + _take(flat, base + cx) * (
                    wgt[..., None] if rows else wgt)
    return acc


def sample_volume_trilinear(data: Tensor, pos: Tensor) -> Tensor:
    """Trilinear fetch from a (D, H, W) volume at texture coordinates
    (..., 3) = (x, y, z); voxel centres at (i+0.5)/dim, edge-clamped."""
    return _trilinear(data.reshape(-1), data.shape, pos)


def sample_volume_trilinear_vec(data: Tensor, pos: Tensor) -> Tensor:
    """Trilinear fetch from a (D, H, W, C) volume (the light volume) at
    texture coordinates (..., 3); returns (..., C). Each corner is one
    gather of whole C-channel rows."""
    return _trilinear(data.reshape(-1, data.shape[3]), data.shape[:3], pos)


def warp_samples_2d(samples: Tensor, guide: Tensor,
                    floor: float = 0.1) -> Tensor:
    """Warp stratified (u, v) samples by the inverse CDF of a (Bv, Bu)
    guide map: the emission density becomes the piecewise-constant mixture
    f = (1 - floor) * guide / mean(guide) + floor, and each sample's pdf
    column is multiplied by f(u', v'), so ``power = radiance / pdf`` stays
    unbiased for any guide. v follows the row-marginal inverse CDF, u the
    conditional inverse CDF of v's row; both invert piecewise-linear CDFs
    exactly, so a stratified grid stays stratified."""
    bv, bu = guide.shape
    dev = samples.device
    fl = torch.tensor(floor, dtype=torch.float32, device=dev)
    g = torch.clamp(guide, min=0.0)
    mean = torch.clamp(g.mean(), min=1e-20)
    f = (1.0 - fl) * g / mean + fl  # (Bv, Bu), mean ~ 1

    u, v = samples[:, 0].contiguous(), samples[:, 1].contiguous()
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    # v: row-marginal inverse CDF.
    mv = f.mean(dim=1)
    mv = mv / mv.sum()
    cdf_v = torch.cat([zero, torch.cumsum(mv, 0)])
    cdf_v[-1] = 1.0
    r = torch.clamp(torch.searchsorted(cdf_v, v, right=True) - 1, 0, bv - 1)
    binmass_v = torch.clamp(cdf_v[r + 1] - cdf_v[r], min=1e-20)
    v2 = (r + (v - cdf_v[r]) / binmass_v) / bv
    pdf_v = binmass_v * bv

    # u: conditional inverse CDF of row r.
    rowsum = torch.clamp(f.sum(dim=1, keepdim=True), min=1e-20)
    cdf_u = torch.cat([zero.expand(bv, 1), torch.cumsum(f / rowsum, 1)], 1)
    cdf_u[:, -1] = 1.0
    rows = cdf_u[r]  # (N, Bu+1)
    c = torch.clamp((rows <= u[:, None]).sum(1) - 1, 0, bu - 1)
    lo = rows.gather(1, c[:, None])[:, 0]
    hi = rows.gather(1, c[:, None] + 1)[:, 0]
    binmass_u = torch.clamp(hi - lo, min=1e-20)
    u2 = (c + (u - lo) / binmass_u) / bu
    pdf_u = binmass_u * bu

    pdf = samples[:, 3] * (pdf_v * pdf_u)
    return torch.stack([u2, v2, samples[:, 2], pdf], dim=-1)

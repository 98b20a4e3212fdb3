"""Min/max uniform grid of a volume (``cpm_tpu/ops/minmax.py:25-42``).

Cells start at voxel 0 and the last cell along an axis may be partial,
as in the original ``volumeMinMaxKernel``. The reference pools with
"SAME" padding, which shifts the cells when a side is not a multiple of
the cell size; at multiples of the cell size the two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cpm_tpu_torch.core.types import UniformGrid3D, Volume

Tensor = torch.Tensor


def _pool_max(x: Tensor, cell: int) -> Tensor:
    return F.max_pool3d(x[None, None], cell, cell, ceil_mode=True)[0, 0]


def volume_min_max(volume: Volume, cell_size: int = 8) -> UniformGrid3D:
    """(gz, gy, gx, 2) per-cell (min, max) with gz = ceil(D / cell_size)."""
    data = volume.data
    mins = -_pool_max(-data, cell_size)
    maxs = _pool_max(data, cell_size)
    d, h, w = data.shape
    dev = data.device
    return UniformGrid3D(
        data=torch.stack([mins, maxs], dim=-1),
        cell_dim=torch.full((3,), float(cell_size), device=dev),
        volume_dim=torch.tensor([w, h, d], dtype=torch.float32, device=dev),
    )

"""Min/max uniform grids of a volume and of a volume sequence
(``cpm_tpu/ops/minmax.py``: ``volume_min_max`` :25-42,
``sequence_min_max`` :45-55).

Cells start at voxel 0 and the last cell along an axis may be partial,
as in the original ``volumeMinMaxKernel``. The reference pools with
"SAME" padding, which shifts the cells when a side is not a multiple of
the cell size; at multiples of the cell size the two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.types import UniformGrid3D, Volume

Tensor = torch.Tensor


def _pool_max(x: Tensor, cell: int) -> Tensor:
    """Per-cell maximum over the last three axes of ``x``."""
    lead = x.shape[:-3]
    out = F.max_pool3d(x.reshape(-1, 1, *x.shape[-3:]), cell, cell,
                       ceil_mode=True)
    return out.reshape(*lead, *out.shape[-3:])


@telemetry.spanned("importance.minmax")
def volume_min_max(volume: Volume, cell_size: int = 8) -> UniformGrid3D:
    """(gz, gy, gx, 2) per-cell (min, max) with gz = ceil(D / cell_size)."""
    data = volume.data
    d, h, w = data.shape
    dev = data.device
    return UniformGrid3D(
        data=sequence_min_max(data, cell_size),
        cell_dim=torch.full((3,), float(cell_size), device=dev),
        volume_dim=telemetry.wait("minmax.volume_dim", torch.tensor,
                                  [w, h, d], dtype=torch.float32,
                                  device=dev),
    )


def sequence_min_max(volumes: Tensor, cell_size: int = 8) -> Tensor:
    """(T, D, H, W) sequence -> (T, gz, gy, gx, 2) per-cell (min, max) of
    every step, in one batched pass; a (D, H, W) volume gives its
    (gz, gy, gx, 2) grid. Device work only: nothing is uploaded."""
    return torch.stack([-_pool_max(-volumes, cell_size),
                        _pool_max(volumes, cell_size)], dim=-1)

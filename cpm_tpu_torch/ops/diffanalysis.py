"""Temporal difference analysis of a volume sequence
(``cpm_tpu/ops/diffanalysis.py:23-40``): per cell and cyclic time-step pair
(t, t+1), the mean absolute voxel difference over the data range.

Cells start at voxel 0 and the last cell along an axis may be partial, as
in the port's min/max grid; its mean is over its real voxels. The
reference pools with "SAME" padding, which shifts the cells when a side is
not a multiple of the cell size; at multiples the two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def volume_difference_grids(sequence: Tensor, cell_size: int = 8,
                            data_range: float = 1.0) -> Tensor:
    """(T, D, H, W) sequence -> (T, gz, gy, gx) grids, gz = ceil(D /
    cell_size): grid t holds the per-cell mean of
    |v_{(t+1) mod T} - v_t| / data_range."""
    diff = torch.abs(torch.roll(sequence, -1, 0) - sequence) / data_range
    # With no padding and ceil_mode, the last window of an axis is cut at
    # the volume's edge and divided by its real voxel count.
    means = F.avg_pool3d(diff[:, None], cell_size, cell_size, ceil_mode=True)
    return means[:, 0]

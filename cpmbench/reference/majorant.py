"""Per-macrocell extinction majorants for Woodcock tracking
(``cpm_tpu/ops/majorant.py:50-155``).

Per cell, the maximum TF opacity over the cell's dilated [min, max] data
range; zero cells are empty space the tracer jumps, guided by a capped
Chebyshev distance map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cpmbench.reference.types import TransferFunction, Volume
from cpmbench.reference import minmax as minmax_mod

Tensor = torch.Tensor


def opacity_range_max(tf: TransferFunction, lo: Tensor, hi: Tensor) -> Tensor:
    """Exact max of the piecewise-linear TF opacity over [lo, hi]
    (elementwise): the max is at an endpoint or at a control point inside
    the interval."""
    m = torch.maximum(tf.sample_opacity(lo), tf.sample_opacity(hi))
    for s in range(tf.positions.shape[0]):
        inside = (tf.positions[s] >= lo) & (tf.positions[s] <= hi)
        m = torch.where(inside, torch.maximum(m, tf.colors[s, 3]), m)
    return m


def _window_max(x: Tensor, size: int) -> Tensor:
    """Stride-1 max over a size^3 window centred on each cell; cells past
    the border do not take part."""
    return F.max_pool3d(x[None, None], size, 1, size // 2)[0, 0]


def dilate_min_max(mins: Tensor, maxs: Tensor,
                   rings: int = 1) -> tuple[Tensor, Tensor]:
    """(2*rings+1)^3 stride-1 min/max pooling."""
    size = 2 * rings + 1
    return -_window_max(-mins, size), _window_max(maxs, size)


def build_majorant_grid(volume: Volume, tf: TransferFunction,
                        cell_size: int = 8, rings: int = 1) -> Tensor:
    """(gz, gy, gx) per-cell majorant opacity over the ``rings``-dilated
    per-cell data range."""
    mm = minmax_mod.sequence_min_max(volume.data, cell_size)
    mins, maxs = dilate_min_max(mm[..., 0], mm[..., 1], rings)
    return torch.clamp(opacity_range_max(tf, mins, maxs), min=0.0)


def block_exit_distance(origin: Tensor, direction: Tensor, cell: Tensor,
                        cell_ext: Tensor, ring: int = 1) -> Tensor:
    """Ray parameter t at which the ray leaves the (2*ring+1)^3 block of
    cells centred on ``cell`` (int xyz)."""
    c = cell.to(torch.float32)
    face = torch.where(direction > 0.0,
                       (c + 1.0 + ring) * cell_ext,
                       (c - ring) * cell_ext)
    t_face = torch.where(torch.abs(direction) > 1e-12,
                         (face - origin) / direction, torch.inf)
    return torch.amin(t_face, dim=-1)


def empty_distance_grid(maj: Tensor, cap: int = 6) -> Tensor:
    """Chebyshev distance in cells, capped at ``cap``, from each cell to the
    nearest cell with a nonzero majorant, eroded by one cell."""
    d = torch.where(maj > 0.0, 0.0, float(cap + 1))

    def min3(x):
        return -_window_max(-x, 3)

    for _ in range(cap):
        d = torch.minimum(d, min3(d) + 1.0)
    return torch.clamp(min3(d), max=float(cap))

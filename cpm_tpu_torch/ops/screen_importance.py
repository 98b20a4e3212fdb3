"""Screen-space (camera-visibility) importance
(``cpm_tpu/ops/screen_importance.py``): for every pixel, the DDA walk from
the ray's entry into the volume to its exit through the min/max grid,
accumulating the t-coverage of the cells whose data range overlaps the
visible window of the transfer function, times the segment's length.

:func:`cell_visibility_from_camera` is the cell-space dual that
``build_importance_grid`` mixes in: 1 for the visible cells that camera
rays cross, 0 elsewhere.
"""

from __future__ import annotations

import torch

from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.types import TransferFunction, UniformGrid3D
from cpm_tpu_torch.ops import intersect
from cpm_tpu_torch.ops.path_importance import grid_segment_integral

Tensor = torch.Tensor


def data_threshold_from_tf(tf: TransferFunction) -> Tensor:
    """(2,) visible data window [lo, hi]: a TF end point with zero alpha
    moves that edge to its position."""
    lo = torch.where(tf.colors[0, 3] > 0.0, 0.0, tf.positions[0])
    hi = torch.where(tf.colors[-1, 3] > 0.0, 1.0, tf.positions[-1])
    return torch.stack([lo, hi])


def visibility_grid(minmax: UniformGrid3D, threshold: Tensor) -> Tensor:
    """(gz, gy, gx): 1 where the cell's [min, max] overlaps the window."""
    culled = ((minmax.data[..., 1] < threshold[0])
              | (minmax.data[..., 0] > threshold[1]))
    return torch.where(culled, 0.0, 1.0)


def _rays(camera: Camera, width: int, height: int):
    """Flat camera rays and their spans through the unit box, the start
    clamped to the eye: (o, d, hit, t0, t1)."""
    origins, dirs = camera.rays(width, height)
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    hit, t0, t1 = intersect.ray_box(o, d)
    return o, d, hit, torch.clamp(t0, min=0.0), t1


def screen_space_importance(minmax: UniformGrid3D, tf: TransferFunction,
                            camera: Camera, width: int = 128,
                            height: int = 128,
                            max_steps: int = 96) -> Tensor:
    """(height, width) per-pixel importance: the visible cells' t-coverage
    along the entry-to-exit segment, times its length in texture space."""
    o, d, hit, t0, t1 = _rays(camera, width, height)
    entry = o + t0[:, None] * d
    exit_ = o + t1[:, None] * d
    x1 = entry * minmax.volume_dim
    x2 = exit_ * minmax.volume_dim
    vis = visibility_grid(minmax, data_threshold_from_tf(tf))
    imp = grid_segment_integral(vis, x1, x2, minmax.cell_dim,
                                max_steps=max_steps)
    # The integral is scaled by the voxel-space length; rescale to the
    # texture-space one.
    len_idx = torch.linalg.vector_norm(x2 - x1, dim=-1)
    len_tex = torch.linalg.vector_norm(exit_ - entry, dim=-1)
    imp = torch.where(hit & (len_idx > 1e-12),
                      imp * len_tex / torch.clamp(len_idx, min=1e-12), 0.0)
    return imp.reshape(height, width)


def cell_visibility_from_camera(minmax: UniformGrid3D, tf: TransferFunction,
                                camera: Camera, width: int = 64,
                                height: int = 64,
                                n_steps: int = 64) -> Tensor:
    """(gz, gy, gx) in {0, 1}: the visible cells that ``n_steps`` midpoint
    samples of a width x height bundle of camera rays fall in."""
    gz, gy, gx = minmax.data.shape[:3]
    n_cells = gx * gy * gz
    dev = minmax.data.device
    gdim = torch.tensor([gx, gy, gz], dtype=torch.float32, device=dev)
    o, d, hit, t0, t1 = _rays(camera, width, height)
    ts = t0[:, None] + (t1 - t0)[:, None] * (
        (torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5)
        / n_steps)[None, :]
    p = o[:, None, :] + ts[..., None] * d[:, None, :]  # (P, S, 3)
    cell = torch.clamp(torch.floor(p * gdim), min=torch.zeros_like(gdim),
                       max=gdim - 1.0).to(torch.int64)
    flat = (cell[..., 2] * gy + cell[..., 1]) * gx + cell[..., 0]
    # Rays that miss the box mark the extra last cell, which is dropped.
    flat = torch.where(hit[:, None], flat, n_cells)
    covered = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
    covered[flat.reshape(-1)] = 1.0
    covered = covered[:-1].reshape(gz, gy, gx)
    return covered * visibility_grid(minmax, data_threshold_from_tf(tf))

"""Ray/box intersection (``cpm_tpu/ops/intersect.py``): the slab test
and the light samples' spans against the volume box."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _as(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def ray_box(origin: Tensor, direction: Tensor, box_min=0.0, box_max=1.0,
            t0=0.0, t1=3.4e38):
    """Slab-method ray/AABB intersection.

    ``origin``/``direction`` are (..., 3); ``box_min``/``box_max`` scalars or
    (3,) corners; ``t0``/``t1`` the initial parametric clip range.
    Returns (hit, tNear, tFar).
    """
    box_min = _as(box_min, origin)
    box_max = _as(box_max, origin)
    # Huge but finite reciprocals keep the slab logic right for
    # axis-parallel rays.
    inv_d = torch.where(torch.abs(direction) > 1e-30, 1.0 / direction,
                        torch.sign(direction) * 1e30
                        + (direction == 0).to(torch.float32) * 1e30)
    ta = (box_min - origin) * inv_d
    tb = (box_max - origin) * inv_d
    t_near = torch.amax(torch.minimum(ta, tb), dim=-1)
    t_far = torch.amin(torch.maximum(ta, tb), dim=-1)
    t_near = torch.maximum(t_near, _as(t0, origin))
    t_far = torch.minimum(t_far, _as(t1, origin))
    return t_near <= t_far, t_near, t_far


def light_sample_box_intersection(origins: Tensor, directions: Tensor,
                                  box_min=0.0, box_max=1.0) -> Tensor:
    """[tStart, tEnd] spans of light-sample rays against the volume box;
    misses become (0, -1)."""
    hit, tn, tf = ray_box(origins, directions, box_min, box_max)
    tn = torch.where(hit, tn, 0.0)
    tf = torch.where(hit, tf, -1.0)
    return torch.stack([tn, tf], dim=-1)


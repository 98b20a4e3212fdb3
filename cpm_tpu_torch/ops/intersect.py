"""Ray/box and ray/mesh intersection (``cpm_tpu/ops/intersect.py``):
the slab test, the light samples' spans against the volume box, and the
same spans against a closed triangle mesh
(lightsamplemeshintersection.cl:36-58)."""

from __future__ import annotations

import numpy as np
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.device import resolve

Tensor = torch.Tensor


def _as(x, like: Tensor) -> Tensor:
    if isinstance(x, Tensor):
        return torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return telemetry.wait("intersect.box", torch.as_tensor, x,
                          dtype=torch.float32, device=like.device)


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


def ray_triangles(origins: Tensor, directions: Tensor, v0: Tensor,
                  v1: Tensor, v2: Tensor, eps: float = 1e-7):
    """Batched Moller-Trumbore: every (ray, triangle) pair at once, as one
    dense (N, F) batch (scene bounding meshes have F ~ 10-100 faces).

    ``origins``/``directions`` are (N, 3), ``v0``/``v1``/``v2`` the (F, 3)
    vertices. Returns (hit, t), both (N, F); ``t`` holds only where
    ``hit``."""
    e1 = v1 - v0  # (F, 3)
    e2 = v2 - v0
    d = directions[:, None, :]  # (N, 1, 3)
    p = torch.linalg.cross(d, e2[None, :, :])  # (N, F, 3)
    det = torch.sum(p * e1[None, :, :], dim=-1)  # (N, F)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    s = origins[:, None, :] - v0[None, :, :]  # (N, F, 3)
    u = torch.sum(s * p, dim=-1) * inv_det
    q = torch.linalg.cross(s, e1[None, :, :])
    v = torch.sum(q * d, dim=-1) * inv_det
    t = torch.sum(q * e2[None, :, :], dim=-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    return hit, t


def light_sample_mesh_intersection(origins: Tensor, directions: Tensor,
                                   vertices: Tensor, faces: Tensor) -> Tensor:
    """[tStart, tEnd] spans of light-sample rays against a closed triangle
    mesh (``vertices`` (V, 3) texture space, ``faces`` (F, 3) indices):
    the least and the largest hit over all faces; misses become (0, -1),
    a single graze (t, t). An odd count of forward hits puts the origin
    inside the mesh, and the span starts at 0."""
    f = faces.to(torch.int64)
    hit, t = ray_triangles(origins, directions, vertices[f[:, 0]],
                           vertices[f[:, 1]], vertices[f[:, 2]])
    big = 3.4e38
    tn = torch.amin(torch.where(hit, t, big), dim=-1)
    tf = torch.amax(torch.where(hit, t, -big), dim=-1)
    any_hit = hit.any(dim=-1)
    inside = hit.sum(dim=-1) % 2 == 1
    tn = torch.where(inside | ~any_hit, 0.0, tn)
    tf = torch.where(any_hit, tf, -1.0)
    return torch.stack([tn, tf], dim=-1)


def box_mesh(box_min=(0.0, 0.0, 0.0), box_max=(1.0, 1.0, 1.0),
             device=None):
    """The proxy cube as a 12-triangle mesh: (vertices (8, 3) float32,
    faces (12, 3) int32), on the card unless ``device`` names another."""
    lo = np.asarray(box_min, np.float32)
    hi = np.asarray(box_max, np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]],
                       np.float32)
    faces = np.array([
        [0, 1, 3], [0, 3, 2],  # z = lo
        [4, 7, 5], [4, 6, 7],  # z = hi
        [0, 5, 1], [0, 4, 5],  # y = lo
        [2, 3, 7], [2, 7, 6],  # y = hi
        [0, 2, 6], [0, 6, 4],  # x = lo
        [1, 5, 7], [1, 7, 3],  # x = hi
    ], np.int32)
    device = resolve(device)
    return (torch.from_numpy(corners).to(device),
            torch.from_numpy(faces).to(device))

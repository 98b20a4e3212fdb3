"""Light-plane fitting for directional lights.

Given a light direction and the scene's bounding geometry, fit the minimal
oriented rectangle perpendicular to the light so every emitted sample ray can
hit the scene: project vertices onto the plane, take the 2D convex hull, and
find the minimum-area oriented bounding rectangle by rotating edges.

Reference parity (math re-derived, host-side CPU code there too):
- convex hull:      modules/lightcl/convexhull2d.cpp (Andrew monotone chain)
- min-area rect:    modules/lightcl/orientedboundingbox2d.cpp:40-78
- plane-aligned fit: orientedboundingbox2d.cpp:81-102
- sample placement: modules/lightcl/cl/directionallightsampler.cl:37-62

These run on host (numpy) at scene-setup time: the input is a handful of
bounding-box vertices, far too small for a kernel.

The port's own copy of ``cpm_tpu/ops/lightplane.py`` (numpy only); the
tests hold the two against each other.
"""

from __future__ import annotations

import numpy as np


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns hull vertices in CCW order."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def minimum_bounding_rectangle(hull: np.ndarray):
    """Minimum-area oriented rectangle over a convex hull.

    Returns (origin, u, v): lower-left corner and the two side vectors, the
    exact output contract of the reference's mimumBoundingRectangle
    (orientedboundingbox2d.cpp:40-78)."""
    hull = np.asarray(hull, np.float64)
    n = len(hull)
    if n == 0:
        return np.zeros(2), np.array([1.0, 0.0]), np.array([0.0, 1.0])
    if n == 1:
        return hull[0], np.zeros(2), np.zeros(2)
    best = (np.inf, None, None, None)
    j = n - 1
    for i in range(n):
        e0 = hull[i] - hull[j]
        norm = np.linalg.norm(e0)
        if norm < 1e-12:
            j = i
            continue
        e0 = e0 / norm
        e1 = np.array([-e0[1], e0[0]])
        d = hull - hull[j]
        p0 = d @ e0
        p1 = d @ e1
        min0, max0 = min(p0.min(), 0.0), max(p0.max(), 0.0)
        min1, max1 = min(p1.min(), 0.0), max(p1.max(), 0.0)
        area = (max0 - min0) * (max1 - min1)
        if area < best[0]:
            origin = hull[j] + min(min0, 0.0) * e0 + min(min1, 0.0) * e1
            best = (area, origin, e0 * (max0 - min0), e1 * (max1 - min1))
        j = i
    return best[1], best[2], best[3]


def fit_light_plane(points: np.ndarray, light_dir: np.ndarray,
                    margin: float = 0.0):
    """Fit an oriented rectangle perpendicular to ``light_dir`` covering the
    projection of ``points``, placed on the lit side of the scene.

    Args:
      points: (P, 3) scene-bounding vertices (world or texture space).
      light_dir: (3,) direction of light propagation (normalized inside).
      margin: relative enlargement of the rectangle.

    Returns:
      (origin, u, v, area): plane origin (3,), side vectors u/v (3,), area.
    """
    points = np.asarray(points, np.float64)
    n = np.asarray(light_dir, np.float64)
    n = n / np.linalg.norm(n)
    # Plane through the point most opposed to the light direction so all
    # geometry is in front of the emission plane.
    dist = points @ n
    plane_pt = points[np.argmin(dist)] - 1e-3 * n

    # In-plane axes (orientedboundingbox2d.cpp:81-90): seed with the world
    # axis LEAST aligned with the plane normal, else an axis-aligned light
    # (e.g. straight down) degenerates to a zero-length projection.
    if abs(n[0]) < abs(n[1]):
        a = np.array([1.0, 0.0, 0.0])
    else:
        a = np.array([0.0, 1.0, 0.0])
    u_axis = a - np.dot(a, n) * n  # project the seed axis onto the plane
    u_axis /= np.linalg.norm(u_axis)
    v_axis = np.cross(n, u_axis)
    v_axis /= np.linalg.norm(v_axis)

    rel = points - plane_pt
    proj = np.stack([rel @ u_axis, rel @ v_axis], axis=-1)
    hull = convex_hull_2d(proj)
    o2, u2, v2 = minimum_bounding_rectangle(hull)
    if margin > 0.0:
        o2 = o2 - 0.5 * margin * (u2 + v2)
        u2 = u2 * (1.0 + margin)
        v2 = v2 * (1.0 + margin)
    origin = plane_pt + o2[0] * u_axis + o2[1] * v_axis
    u3 = u2[0] * u_axis + u2[1] * v_axis
    v3 = v2[0] * u_axis + v2[1] * v_axis
    area = np.linalg.norm(u3) * np.linalg.norm(v3)
    return (origin.astype(np.float32), u3.astype(np.float32),
            v3.astype(np.float32), np.float32(area))


def unit_box_corners(box_min=0.0, box_max=1.0) -> np.ndarray:
    lo = np.broadcast_to(np.asarray(box_min, np.float64), (3,))
    hi = np.broadcast_to(np.asarray(box_max, np.float64), (3,))
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    return corners

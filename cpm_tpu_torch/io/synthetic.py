"""Synthetic volume generators for tests and benchmarks.

BASELINE.json configs: 64^3 sphere-in-box (config 1), 128^3 smoke/cloud
(config 2), time-varying 128^3 x 32-step sequence (config 4).

The port's own copy of ``cpm_tpu/io/synthetic.py`` (numpy only); the tests
hold the two against each other.
"""

from __future__ import annotations

import numpy as np


def sphere_in_box(dim: int = 64, radius: float = 0.3,
                  center=(0.5, 0.5, 0.5), soft: float = 0.05) -> np.ndarray:
    """Soft-edged sphere density in [0,1], shape (D, H, W)."""
    zs, ys, xs = np.meshgrid(*( (np.arange(dim) + 0.5) / dim, ) * 3,
                             indexing="ij")
    r = np.sqrt((xs - center[0]) ** 2 + (ys - center[1]) ** 2
                + (zs - center[2]) ** 2)
    d = np.clip((radius - r) / max(soft, 1e-6) + 0.5, 0.0, 1.0)
    return d.astype(np.float32)


def smoke_cloud(dim: int = 128, seed: int = 0, octaves: int = 4) -> np.ndarray:
    """Fractal value-noise cloud in [0,1], shape (D, H, W)."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((dim, dim, dim), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        n = max(2, dim >> (octaves - 1 - o + 2))
        coarse = rng.random((n, n, n)).astype(np.float32)
        # trilinear upsample to dim^3
        idx = np.linspace(0, n - 1, dim)
        i0 = np.floor(idx).astype(int)
        i1 = np.minimum(i0 + 1, n - 1)
        f = (idx - i0).astype(np.float32)

        def lerp_axis(a, axis):
            a0 = np.take(a, i0, axis=axis)
            a1 = np.take(a, i1, axis=axis)
            shape = [1, 1, 1]
            shape[axis] = dim
            return a0 + (a1 - a0) * f.reshape(shape)

        up = lerp_axis(lerp_axis(lerp_axis(coarse, 0), 1), 2)
        acc += amp * up
        total += amp
        amp *= 0.5
    acc /= total
    # Carve cloud shape: radial falloff, the squares of the (z, y, x)
    # offsets summed by broadcasting (the same float64 operations as over
    # a meshgrid, without its three dim^3 arrays).
    c2 = ((np.arange(dim) + 0.5) / dim - 0.5) ** 2
    falloff = np.clip(1.0 - 2.2 * np.sqrt(
        c2[None, None, :] + c2[None, :, None] + c2[:, None, None]), 0, 1)
    out = np.clip((acc - 0.4) * 2.5, 0, 1) * falloff
    return out.astype(np.float32)


def time_varying_sequence(dim: int = 128, steps: int = 32,
                          seed: int = 0) -> np.ndarray:
    """(T, D, H, W) sequence: a sphere orbiting inside the box with a
    pulsating radius — localized changes per step, exercising correlated
    selective recomputation (BASELINE config 4)."""
    out = np.empty((steps, dim, dim, dim), np.float32)
    for t in range(steps):
        ang = 2 * np.pi * t / steps
        c = (0.5 + 0.22 * np.cos(ang), 0.5 + 0.22 * np.sin(ang), 0.5)
        r = 0.18 + 0.05 * np.sin(2 * ang)
        out[t] = sphere_in_box(dim, radius=r, center=c)
    return out


def default_tf_points():
    """A simple ramp TF: transparent below 0.1, colored above."""
    positions = [0.0, 0.1, 0.5, 1.0]
    colors = [
        (0.0, 0.0, 0.0, 0.0),
        (0.2, 0.3, 0.9, 0.02),
        (0.9, 0.6, 0.2, 0.3),
        (1.0, 1.0, 1.0, 0.8),
    ]
    return positions, colors


def default_scattering_points(albedo: float = 0.9):
    """Scattering TF whose opacity channel controls the scattering albedo:
    albedo = scat.w / (scat.w + color.w) (photontracer.cl:174)."""
    positions, colors = default_tf_points()
    scat = [(r, g, b, a * albedo / max(1.0 - albedo, 1e-3))
            for (r, g, b, a) in colors]
    return positions, scat


def ct_head_like(dim: int = 256) -> np.ndarray:
    """CT-head-like phantom for BASELINE config 3: a high-density ellipsoid
    shell (skull) around a medium-density interior (soft tissue) with an
    embedded brighter core, on empty background — the value distribution a
    head-CT transfer function discriminates
    (workspaces/CorrelatedPhotonMappingSingleVolume.inv analog)."""
    z, y, x = np.mgrid[0:dim, 0:dim, 0:dim].astype(np.float32) / dim
    # Ellipsoidal radius around the center (head slightly elongated in z).
    r = np.sqrt(((x - 0.5) / 0.32) ** 2 + ((y - 0.5) / 0.38) ** 2
                + ((z - 0.5) / 0.42) ** 2)
    skull = np.clip(1.0 - np.abs(r - 0.92) / 0.08, 0.0, 1.0)  # thin shell
    tissue = np.where(r < 0.88, 0.35, 0.0)
    core = np.clip(0.6 - np.sqrt((x - 0.55) ** 2 + (y - 0.5) ** 2
                                 + (z - 0.45) ** 2) / 0.2, 0.0, 0.6)
    return np.clip(0.9 * skull + tissue + core, 0.0, 1.0).astype(np.float32)

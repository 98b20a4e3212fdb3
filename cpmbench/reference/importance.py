"""Importance-grid construction: min/max grid + transfer function ->
per-cell visual importance, with the time-varying and the incremental
TF-difference modes (``cpm_tpu/ops/importance.py``).

The per-cell walk over the TF's segments is a masked reduction over the
(short) point list, dense over (cells x points). ``tf_difference_points``
runs on the host in numpy and is this package's own copy of the
reference's function; a test holds the two together.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cpmbench.reference.types import interp

Tensor = torch.Tensor

LAB_NORMALIZATION = 1.0 / np.linalg.norm([100.0, 500.0, 400.0])

_RGB_TO_XYZ = ((0.4124, 0.3576, 0.1805),
               (0.2126, 0.7152, 0.0722),
               (0.0193, 0.1192, 0.9505))
_WHITE_D65 = (0.95047, 1.0, 1.08883)


@dataclass(frozen=True)
class ImportanceWeights:
    """Raw UI weights; ``normalized()`` applies the host-side scaling."""

    color: float = 1.0
    color_diff: float = 1.0
    opacity_diff: float = 1.0
    opacity: float = 1.0

    def normalized(self):
        s = self.color + self.color_diff + self.opacity_diff + self.opacity
        if s <= 0.0:
            s = 1.0
        return (self.color * LAB_NORMALIZATION / s,
                self.color_diff * LAB_NORMALIZATION / s,
                self.opacity_diff / s,
                self.opacity / s)


def rgb2lab(rgb: Tensor) -> Tensor:
    """sRGB -> CIELAB D65: gamma expansion, XYZ, then the Lab f() with the
    0.008856 cube-root split."""
    c = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                    rgb / 12.92)
    m = torch.tensor(_RGB_TO_XYZ, dtype=torch.float32, device=rgb.device)
    # An elementwise product and a sum of three terms: a matrix product
    # here could run in TF32 on the card.
    xyz = (c[..., None, :] * m).sum(-1)
    r = xyz / torch.tensor(_WHITE_D65, dtype=torch.float32,
                           device=rgb.device)
    cbrt = torch.sign(r) * torch.abs(r) ** (1.0 / 3.0)
    f = torch.where(r > 0.008856, cbrt, (903.3 * r + 16.0) / 116.0)
    lum = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([lum, a, b], dim=-1)


def _norm(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def tf_points_importance(color: Tensor, next_color: Tensor,
                         weights) -> Tensor:
    """Weighted Lab-magnitude / Lab-difference / opacity metric of two
    RGBA colours; 0 where both are transparent."""
    w_color, w_color_diff, w_opacity_diff, w_opacity = weights
    any_opaque = (color[..., 3] > 0.0) | (next_color[..., 3] > 0.0)
    lab = rgb2lab(color[..., :3])
    next_lab = rgb2lab(next_color[..., :3])
    imp = (w_color * torch.maximum(_norm(next_lab), _norm(lab))
           + w_color_diff * _norm(next_lab - lab)
           + w_opacity_diff * torch.abs(next_color[..., 3] - color[..., 3])
           + w_opacity * torch.maximum(color[..., 3], next_color[..., 3]))
    return torch.where(any_opaque, imp, 0.0)


def tf_points_importance_incremental(next_color: Tensor) -> Tensor:
    """The incremental variant: the sum of the |delta| components."""
    return next_color.sum(-1)


def _interp_color(positions: Tensor, colors: Tensor, x: Tensor) -> Tensor:
    """Piecewise-linear TF evaluation with edge clamping; (..., C)."""
    return torch.stack([interp(x, positions, colors[:, c])
                        for c in range(colors.shape[1])], dim=-1)


def color_envelope(positions: Tensor, colors: Tensor, lo: Tensor,
                   hi: Tensor):
    """Min/max RGBA envelope of the TF over the data range [lo, hi] of each
    cell: the envelope of color(lo), color(hi) and every control point
    strictly inside (lo, hi)."""
    c_lo = _interp_color(positions, colors, lo)
    c_hi = _interp_color(positions, colors, hi)
    # (cells, P, 1)
    interior = ((positions[None, :] > lo[:, None])
                & (positions[None, :] < hi[:, None]))[..., None]
    big = 3.4e38
    cexp = colors[None, :, :]
    cmin_int = torch.where(interior, cexp, big).amin(dim=1)
    cmax_int = torch.where(interior, cexp, -big).amax(dim=1)
    cmin = torch.minimum(torch.minimum(c_lo, c_hi), cmin_int)
    cmax = torch.maximum(torch.maximum(c_lo, c_hi), cmax_int)
    return cmin, cmax


def classify_importance(minmax: Tensor, positions: Tensor, colors: Tensor,
                        weights: tuple | None,
                        incremental: bool = False) -> Tensor:
    """(gz, gy, gx, 2) min/max grid -> (gz, gy, gx) importance; with
    ``incremental`` the TF points are |delta RGBA| points and ``weights``
    is not read."""
    shape = minmax.shape[:-1]
    flat = minmax.reshape(-1, 2)
    cmin, cmax = color_envelope(positions, colors, flat[:, 0].contiguous(),
                                flat[:, 1].contiguous())
    if incremental:
        imp = tf_points_importance_incremental(cmax)
    else:
        imp = tf_points_importance(cmin, cmax, weights)
    return imp.reshape(shape)


def tf_difference_points(positions_a, colors_a, positions_b, colors_b,
                         eps: float = 1e-4):
    """Merge-walk two TF point lists and emit |delta RGBA| points, the
    incremental TF-difference mode (host-side numpy).

    Returns (positions, diff_colors) covering the union of control points;
    segments where the TFs agree within ``eps`` produce zero points.
    """
    pa = np.asarray(positions_a, np.float64)
    pb = np.asarray(positions_b, np.float64)
    ca = np.asarray(colors_a, np.float64)
    cb = np.asarray(colors_b, np.float64)
    union = np.unique(np.concatenate([pa, pb]))

    def interp_rgba(p, c, x):
        return np.stack([np.interp(x, p, c[:, k]) for k in range(4)], -1)

    va = interp_rgba(pa, ca, union)
    vb = interp_rgba(pb, cb, union)
    diff = np.abs(va - vb)
    diff[diff < eps] = 0.0
    return union.astype(np.float32), diff.astype(np.float32)

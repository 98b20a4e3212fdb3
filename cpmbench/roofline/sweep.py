"""The sweep render's forward (the plane pre-pass and the march together):
its operations and bytes for one render.

Operations: every sample of a ray that lies in the box on a valid plane
(counted from the camera's plane schedule, the reference's geometry)
needs a bilinear fetch of the plane's volume slab (3 lerps, 6), a
bilinear fetch of the light slab's three channels (18), one TF evaluation
of four channels (:mod:`cpmbench.roofline.tf`), the extinction and the
segment's transmittance (a product of three, an exponential, a
subtraction: 4) and the emission and front-to-back composite (light plus
ambient 3, times the colour 3, the weight 1, three multiply-adds 6, the
transmittance 1: 14). Each plane lerps its two volume slabs and its two
light slabs once (2 operations a texel and channel).

Bytes: the volume and the light volume read once, the intermediate
(V, U, 4) float32 image written once.
"""

from __future__ import annotations

import torch

from cpmbench.reference import sweep_render as S
from cpmbench.roofline import peaks, tf

SAMPLE_OPS = 6 + 18 + 4 + 14  # without the TF evaluation
LERP_OPS = 2


def in_box_samples(sched, u: torch.Tensor, v: torch.Tensor) -> int:
    """Samples in the box on valid planes: per plane, the base-grid columns
    and rows whose scaled coordinate lies in [0, 1]."""
    w = sched.w_planes[:, None]
    b = sched.o_b + w * (u[None, :] - sched.o_b)
    c = sched.o_c + w * (v[None, :] - sched.o_c)
    nb = ((b >= 0.0) & (b <= 1.0)).sum(1)
    nc = ((c >= 0.0) & (c <= 1.0)).sum(1)
    return int((nb * nc * sched.valid.to(nb.dtype)).sum())


def forward_work(volume_shape: tuple, light_dim: int, camera, render_cfg,
                 tf_points: int) -> tuple[float, float]:
    """(operations, bytes) of one render of a (D, H, W) volume and a
    light volume of side ``light_dim`` through ``camera`` (the reference's
    :class:`~cpmbench.reference.camera.Camera`)."""
    axis, sign = S.principal_axis(camera)
    na = volume_shape[2 - axis]
    n_planes = max(2, int(na * render_cfg.sampling_rate))
    U = S._round_up(int(render_cfg.width * render_cfg.inter_scale), 128)
    V = S._round_up(int(render_cfg.height * render_cfg.inter_scale), 128)
    eye_a = float(camera.host("eye")[axis])
    z_first = 0.5 / n_planes if sign > 0 else 1.0 - 0.5 / n_planes
    signs = (1, -1) if (z_first - eye_a) * sign <= 1e-6 else (sign,)
    d, h, w = volume_shape
    # A plane across marching axis a (x, y, z) spans the other two.
    plane_texels = (d * h, d * w, h * w)[axis]
    volume_bytes = 4 * d * h * w + 12 * light_dim ** 3
    ops = nbytes = 0.0
    for s in signs:
        sched = S._plane_schedule(camera, axis, s, n_planes,
                                  render_cfg.width, render_cfg.height)
        u, v = S.base_grid(sched, U, V)
        samples = in_box_samples(sched, u, v)
        ops += samples * (SAMPLE_OPS + tf.eval_ops(tf_points, 4))
        ops += n_planes * LERP_OPS * (plane_texels + 3 * light_dim ** 2)
        nbytes += volume_bytes + 16 * U * V
    return ops, nbytes


def bound_s(*args) -> float:
    return peaks.bound_s(*forward_work(*args))

"""Light-sample emission (``cpm_tpu/ops/emit.py``: ``emit_directional``
:31-59 and the ``emit`` dispatcher :235-248).

The light-plane fit is host work in numpy (``ops/lightplane.py``).
Point, cone and area lights are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from cpm_tpu_torch.core import lights as L
from cpm_tpu_torch.core.types import LightSamples
from cpm_tpu_torch.ops import intersect, lightplane

Tensor = torch.Tensor


def emit_directional(light: L.Light, samples: Tensor) -> LightSamples:
    """Place (N, 4) (u, v, _, pdf) samples on the light plane fitted to the
    unit volume box for a directional light; power = radiance * area /
    pdf."""
    origin, tu, tv, area = lightplane.fit_light_plane(
        lightplane.unit_box_corners(), np.asarray(light.direction))
    dev = samples.device

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    origins = (vec(origin)[None, :] + vec(tu)[None, :] * samples[:, 0:1]
               + vec(tv)[None, :] * samples[:, 1:2])
    directions = vec(light.direction).expand(origins.shape).contiguous()
    pdf = samples[:, 3] / vec(area)
    powers = vec(light.radiance)[None, :] / pdf[:, None]
    tspan = intersect.light_sample_box_intersection(origins, directions)
    return LightSamples(origins=origins, directions=directions,
                        powers=powers, tspan=tspan)


def emit(light: L.Light, samples: Tensor) -> LightSamples:
    """Dispatch on the light type."""
    if light.type == L.DIRECTIONAL:
        return emit_directional(light, samples)
    if light.type in (L.POINT, L.CONE, L.AREA):
        raise NotImplementedError(
            f"light type {light.type} is not ported yet; only directional "
            "lights are")
    raise ValueError(f"unknown light type {light.type}")

"""Light source descriptions.

Reference parity: the ``PackedLightSource`` GPU struct and the per-type
sampling in modules/importancesamplingcl/cl/light/light.cl:82-130
(point / area / directional / cone), plus Inviwo's light-source processors.

A :class:`Light` is a static scene-setup object (host side); the emit stage
turns it into a :class:`~cpmbench.reference.types.LightSamples` device bundle.

A frozen copy of the port's ``core/lights.py`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

POINT = 0
AREA = 1
DIRECTIONAL = 2
CONE = 3


@dataclass(frozen=True)
class Light:
    """A single light source (host-side, static under jit).

    ``radiance`` is RGB; geometry fields are interpreted per type:
    - POINT:        ``position``
    - DIRECTIONAL:  ``direction`` (propagation direction), plane fitted to scene
    - AREA:         ``position`` (center), ``direction`` (normal), ``size`` (w,h)
    - CONE:         ``position``, ``direction``, ``cos_fov``
    """

    type: int
    radiance: tuple = (1.0, 1.0, 1.0)
    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, 1.0)
    size: tuple = (1.0, 1.0)
    cos_fov: float = float(np.cos(np.deg2rad(30.0)))

    @staticmethod
    def directional(direction, radiance=(1.0, 1.0, 1.0)) -> "Light":
        d = np.asarray(direction, np.float64)
        d = tuple((d / np.linalg.norm(d)).tolist())
        return Light(type=DIRECTIONAL, direction=d, radiance=tuple(radiance))

    @staticmethod
    def point(position, radiance=(1.0, 1.0, 1.0)) -> "Light":
        return Light(type=POINT, position=tuple(position),
                     radiance=tuple(radiance))

    @staticmethod
    def cone(position, direction, cos_fov=None, radiance=(1.0, 1.0, 1.0)) -> "Light":
        d = np.asarray(direction, np.float64)
        d = tuple((d / np.linalg.norm(d)).tolist())
        kwargs = {}
        if cos_fov is not None:
            kwargs["cos_fov"] = float(cos_fov)
        return Light(type=CONE, position=tuple(position), direction=d,
                     radiance=tuple(radiance), **kwargs)

    @staticmethod
    def area(position, direction, size=(1.0, 1.0), radiance=(1.0, 1.0, 1.0)) -> "Light":
        d = np.asarray(direction, np.float64)
        d = tuple((d / np.linalg.norm(d)).tolist())
        return Light(type=AREA, position=tuple(position), direction=d,
                     size=tuple(size), radiance=tuple(radiance))

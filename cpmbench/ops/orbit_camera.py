"""A camera orbit step: the eye on a circle of ``radius`` about the
configured centre, the azimuth advanced by a draw from
``azimuth_step_deg``, the elevation drawn from ``elevation_deg``."""

import math


def run(s, step, ctx, record):
    p, mem = step.params, step.mem
    mem["azimuth"] = mem.get("azimuth", 0.0) + float(
        s.draws.uniform(*p["azimuth_step_deg"]))
    elevation = float(s.draws.uniform(*p["elevation_deg"]))
    az, el = math.radians(mem["azimuth"]), math.radians(elevation)
    c = s.cfg["camera"]["center"]
    r = float(p["radius"])
    eye = [c[0] + r * math.cos(el) * math.sin(az),
           c[1] + r * math.sin(el),
           c[2] - r * math.cos(el) * math.cos(az)]
    s.camera = dict(s.camera, eye=eye)
    s.scene = s.side.with_camera(s.scene, s.camera)

"""sweep_roofline.frame: the sweep forward's share of its roofline: the
least time of every render of the traced window
(:mod:`cpmbench.roofline.sweep`) over the device time of its kernels, the
plane pre-pass and the march, from the profiler."""

import re

from cpmbench.reference.camera import Camera
from cpmbench.reference.config import RenderConfig
from cpmbench.roofline import sweep

KERNELS = re.compile(r"\b(sweep_planes_kernel|sweep_scan_kernel)\b")


def read(run):
    renders = (run.notes or {}).get("render")
    if run.trace is None or not renders:
        return None
    device_s = run.trace.kernel_s(lambda n: KERNELS.search(n) is not None)
    if device_s <= 0:
        return None
    cfg = run.cfg
    rc = RenderConfig(width=cfg["image"]["width"],
                      height=cfg["image"]["height"])
    dim = cfg["volume"]["dim"]
    cache, bound = {}, 0.0
    for camera, points in renders:
        key = (tuple(camera["eye"]), points)
        if key not in cache:
            cam = Camera.create(eye=camera["eye"], center=camera["center"],
                                up=camera["up"], fov_y=camera["fov_y"],
                                device=run.device)
            cache[key] = sweep.bound_s((dim, dim, dim),
                                       cfg["light_volume_dim"], cam, rc,
                                       points)
        bound += cache[key]
    return 100.0 * bound / device_s

"""End-to-end demo with the PyTorch/CUDA port, BASELINE config 1 (the
port's counterpart of ``examples/render_sphere.py``): a 64^3 sphere in a
box, one directional light, 65,536 photons, a 512^2 camera.
emit -> trace -> splat -> render.

Run from the repository's root:

    PYTHONPATH=. python examples/render_sphere_torch.py [--device cpu]

Times come from CUDA events on a card and from the host's clock on the
CPU. The image is saved as ``render_sphere_torch.npy`` in the temporary
directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import RenderConfig, TracerConfig
from cpm_tpu_torch.core.device import resolve
from cpm_tpu_torch.core.lights import Light
from cpm_tpu_torch.core.types import TransferFunction, Volume
from cpm_tpu_torch.io import synthetic
from cpm_tpu_torch.ops import emit, rng, sampling, splat, sweep_render, tracer


class _Clock:
    """Milliseconds between marks: CUDA events on a card (the card's own
    time, read after one synchronize), the host's clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans_ms(self) -> list:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def render_sphere(device=None, vol_dim: int = 64, photons_side: int = 256,
                  width: int = 512, max_interactions: int = 4,
                  seed: int = 7) -> dict:
    """BASELINE config 1 at the given sizes: prints the reference's lines
    and returns {"light_samples", "photons", "light_volume", "image",
    "first_ms", "steady_ms"}, the times as (trace, splat, render)."""
    device = resolve(device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    volume = Volume.from_data(synthetic.sphere_in_box(vol_dim),
                              device=device)
    tf = TransferFunction.from_points(*synthetic.default_tf_points(),
                                      device=device)
    tf_s = TransferFunction.from_points(
        *synthetic.default_scattering_points(), device=device)
    light = Light.directional((0.0, -1.0, 0.3), radiance=(1.0, 0.95, 0.9))
    samples = sampling.stratified_grid_2d(photons_side, photons_side,
                                          device=device)
    ls = emit.emit(light, samples)
    cfg = TracerConfig(max_interactions=max_interactions)
    key = rng.prng_key(seed)
    cam = Camera.create(eye=(0.5, 0.7, -1.6), device=device)
    rcfg = RenderConfig(width=width, height=width)

    def run():
        clock = _Clock(device)
        clock.mark()
        photons = tracer.trace_photons(volume, tf, tf_s, ls, key, cfg)
        clock.mark()
        dim = splat.light_volume_dim(photons.radius_rel)
        lv = splat.splat_all(photons, (dim, dim, dim), method="auto")
        clock.mark()
        img = sweep_render.sweep_render(volume, tf, lv, cam, rcfg)
        clock.mark()
        return photons, lv, img, clock.spans_ms()

    photons, lv, img, first = run()
    n_dep = int((photons.positions[..., 0] < 1e30).sum())
    print(f"photons traced: {ls.n}  deposited interactions: {n_dep}")
    print(f"light volume: {tuple(lv.shape)}, mean irradiance "
          f"{float(lv.mean()):.4g}, max {float(lv.max()):.4g}")
    print(f"image: {tuple(img.shape)}, rgb mean "
          f"{float(img[..., :3].mean()):.4f}, alpha mean "
          f"{float(img[..., 3].mean()):.4f}")
    t, s, r = (x / 1e3 for x in first)
    print(f"timings (first call incl. warm-up): trace {t:.2f}s  "
          f"splat {s:.2f}s  render {r:.2f}s")

    photons, lv, img, steady = run()
    t, s, r = steady
    print(f"steady-state: trace {t:.1f}ms "
          f"({ls.n / t / 1e3:.2f} Mphotons/s)  splat {s:.1f}ms  "
          f"render {r:.1f}ms ({width * width / r / 1e3:.2f} Mrays/s)")
    return {"light_samples": ls, "photons": photons, "light_volume": lv,
            "image": img, "first_ms": first, "steady_ms": steady}


def main(argv=None) -> None:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--device", default=None)
    out = render_sphere(args.parse_args(argv).device)
    path = os.path.join(tempfile.gettempdir(), "render_sphere_torch.npy")
    np.save(path, out["image"].cpu().numpy())
    print(f"saved {path}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""On-card smoke run of the PyTorch/CUDA port (``cpm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero, printing
no result, without them. In order it:

1. prints the card's name and power limit;
2. builds the sm_90a splat kernel from ``cpm_tpu_torch/csrc`` and prints
   the build time;
3. holds the kernel against its plain PyTorch version on seeded inputs at
   the main path's shape (262,144 deposits, ~30% unused slots, into 65^3)
   and at a ragged shape, and times both with CUDA events;
4. drives the main path once through the user's entry points
   (``init_state`` -> ``full_trace_step`` -> ``render_state``) at the
   reference's interactive workload: a 128^3 smoke cloud, one directional
   light, 256 x 256 photons with 4 interactions, a 65^3 light volume and a
   512^2 image; asserts that the splat kernel was launched, that photons
   were deposited, that the light volume and image are finite and the image
   not empty, and that the kernel agrees with its plain version on the
   frame's own deposits; then times each stage with CUDA events;
5. runs a small frame (16^3 volume, 32^2 photons, 32^2 pixels) on the
   card and on the CPU, where the tests hold the port against the JAX
   reference, and asserts they agree (relative L1 under 1%);
6. checks the tracer on the card against Beer-Lambert physics in a
   homogeneous volume;
7. prints a ``kernels`` JSON line and, last, the device JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# The reference's numpy-only host modules, shared with the port.
from cpm_tpu.core.lights import Light
from cpm_tpu.io import synthetic
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                       TracerConfig)
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import TransferFunction, Volume
from cpm_tpu_torch.kernels import splat_product as sp
from cpm_tpu_torch.ops import emit, rng, sampling, splat, tracer
from cpm_tpu_torch.pipeline import step

RTOL = 1e-4  # atomics reorder the fp32 sums: rounding-level differences
ATOL_REL = 1e-6  # absolute tolerance, relative to max |plain|
# Card vs CPU on the same small frame: log/exp round differently on the
# two devices, which can flip a Woodcock decision in a few lanes.
FRAME_REL_L1 = 1e-2


def build_frame(device, vol_dim=128, photons=256, max_interactions=4,
                width=512, max_steps=6000):
    """The reference's interactive workload (its bench.py default):
    smoke_cloud(vol_dim, seed=3), default TFs, one directional light at
    (0, -1, 0.3), the default camera."""
    volume = Volume.from_data(synthetic.smoke_cloud(vol_dim, seed=3),
                              device=device)
    tf = TransferFunction.from_points(*synthetic.default_tf_points(),
                                      device=device)
    tfs = TransferFunction.from_points(
        *synthetic.default_scattering_points(), device=device)
    scene = Scene.create(volume, tf, tfs,
                         [Light.directional((0.0, -1.0, 0.3))],
                         Camera.create(device=device))
    config = PipelineConfig(
        photons_x=photons, photons_y=photons,
        tracer=TracerConfig(max_interactions=max_interactions,
                            max_steps=max_steps),
        render=RenderConfig(width=width, height=width))
    return scene, config


def run_frame(scene, config):
    """The main path through the entry points: (state, image)."""
    state = step.init_state(scene, config)
    state = step.full_trace_step(scene, state, config)
    return state, step.render_state(scene, state, config)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Assert got ~ ref at RTOL / ATOL_REL * max|ref|; returns max abs err."""
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL_REL * scale,
                               msg=lambda m: f"{what}: {m}")
    print(f"{what}: max_abs_err {err:.3e} (max |ref| {scale:.3e})")
    return err


def seeded_deposits(m: int, seed: int, sentinel_frac: float, device):
    rs = np.random.default_rng(seed)
    pos = rs.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    pw = rs.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    unused = rs.random(m) < sentinel_frac
    pos[unused] = np.float32(3.4028235e38)
    pw[unused] = 0.0
    return torch.from_numpy(pos).to(device), torch.from_numpy(pw).to(device)


def check_kernel(dev, tag) -> dict:
    """Kernel vs plain version at the main-path and a ragged shape."""
    r = 0.0153866
    pos, pw = seeded_deposits(262144, 0, 0.3, dev)
    main_dim = (65, 65, 65)
    got = sp.splat_product(pos, pw, r, main_dim)
    ref = sp.splat_product_torch(pos, pw, r, main_dim)
    torch.cuda.synchronize()
    err = compare(got, ref, "splat kernel vs plain, 262144 deposits -> 65^3")
    rpos, rpw = seeded_deposits(1000, 1, 0.3, dev)
    rdim = (17, 23, 29)
    compare(sp.splat_product(rpos, rpw, 0.07, rdim),
            sp.splat_product_torch(rpos, rpw, 0.07, rdim),
            "splat kernel vs plain, 1000 deposits -> 17x23x29")
    ms = cuda_ms(lambda: sp.splat_product(pos, pw, r, main_dim), reps=50)
    plain_ms = cuda_ms(lambda: sp.splat_product_torch(pos, pw, r, main_dim),
                       reps=5)
    print(f"splat at 262144 -> 65^3: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({tag})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def rel_l1(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want.cpu()).abs().sum() / want.abs().sum())


def check_small_frame(dev) -> None:
    """The same small frame on the card and on the CPU."""
    small = dict(vol_dim=16, photons=32, max_interactions=2, width=32)
    gpu_state, gpu_img = run_frame(*build_frame(dev, **small))
    cpu_state, cpu_img = run_frame(*build_frame(torch.device("cpu"), **small))
    lv_err = rel_l1(gpu_state.light_volume, cpu_state.light_volume)
    img_err = rel_l1(gpu_img, cpu_img)
    print(f"small frame, card vs CPU: light volume rel L1 {lv_err:.3e}, "
          f"image rel L1 {img_err:.3e}")
    if float(cpu_img[..., 3].max()) <= 0.0:
        raise AssertionError("the small frame's image is empty")
    if not (lv_err < FRAME_REL_L1 and img_err < FRAME_REL_L1):
        raise AssertionError("the card and the CPU disagree on a small frame")


def check_beer_lambert(dev) -> None:
    """Homogeneous 16^3 slab lit along +z: the interaction fraction is
    1 - exp(-sigma) and the first-interaction depth a truncated exponential
    (the reference's tests/test_tracer.py:39-58)."""
    sbi = 150.0
    for opacity in (0.3, 0.2):
        vol = Volume.from_data(np.ones((16, 16, 16), np.float32), device=dev)
        tf = TransferFunction.from_points(
            [0.0, 1.0], [(1, 1, 1, opacity)] * 2, device=dev)
        scat_w = opacity * 0.9 / 0.1
        tfs = TransferFunction.from_points(
            [0.0, 1.0], [(1, 1, 1, scat_w)] * 2, device=dev)
        ls = emit.emit(Light.directional([0.0, 0.0, 1.0]),
                       sampling.stratified_grid_2d(128, 128, device=dev))
        ph = tracer.trace_photons(vol, tf, tfs, ls, rng.prng_key(0),
                                  TracerConfig(max_interactions=1))
        pos = ph.positions[0].cpu().numpy()
        hit = pos[:, 0] < 1e30
        sigma = opacity * sbi
        frac = float(hit.mean())
        want = 1.0 - np.exp(-sigma)
        mean_depth = float(pos[hit, 2].mean())
        want_depth = 1.0 / sigma - np.exp(-sigma) / (1 - np.exp(-sigma))
        print(f"beer-lambert opacity {opacity}: interacted {frac:.4f} "
              f"(expect {want:.4f}), mean depth {mean_depth:.5f} "
              f"(expect {want_depth:.5f})")
        if abs(frac - want) > 0.02 or abs(mean_depth / want_depth - 1) > 0.05:
            raise AssertionError("tracer fails the Beer-Lambert check")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    dev = torch.device("cuda", 0)
    tag = card()
    print(tag)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda)

    t0 = time.perf_counter()
    _, log = sp.build()
    print(f"built {sp.SOURCE.name} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s")
    print(log.strip())

    kernel = check_kernel(dev, tag)

    # --- the main path, counted ---
    scene, config = build_frame(dev)
    torch.cuda.synchronize()
    sp.splat_product.launches = 0
    t0 = time.perf_counter()
    state, img = run_frame(scene, config)
    torch.cuda.synchronize()
    launches = sp.splat_product.launches
    print(f"main path (first run, includes warm-up): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({tag})")
    if launches < 1:
        raise AssertionError("the main path did not launch the splat kernel")
    deposited = int((state.photons.positions[..., 0] < 1e30).sum())
    lv = state.light_volume
    print(f"launches {launches}, deposited photons {deposited}, light "
          f"volume {tuple(lv.shape)} sum {float(lv.sum()):.6g}, image "
          f"{tuple(img.shape)} alpha max {float(img[..., 3].max()):.4f}")
    if deposited <= 0:
        raise AssertionError("no photon was deposited")
    if not (bool(torch.isfinite(lv).all()) and bool(torch.isfinite(img).all())):
        raise AssertionError("non-finite light volume or image")
    if img.shape != (512, 512, 4) or float(img[..., 3].max()) <= 0.0:
        raise AssertionError("empty or misshapen image")

    # The frame's light volume (kernel) against the plain version of the
    # splat on the frame's own deposits.
    ph = state.photons
    dim = step.light_volume_shape(config)
    compare(lv, splat.splat_all(ph, dim, method="matmul"),
            "frame light volume (kernel) vs plain splat")

    # --- per-stage times (warm), CUDA events ---
    key = rng.fold_in(state.key, 0)
    samples = state.light_samples
    stages = {
        "init_state (emit)": lambda: step.init_state(scene, config),
        "trace_photons": lambda: tracer.trace_photons(
            scene.volume, scene.tf, scene.tf_scattering, samples, key,
            config.tracer),
        "splat_all (kernel)": lambda: splat.splat_all(
            ph, dim, method="cuda"),
        "splat_all (plain)": lambda: splat.splat_all(
            ph, dim, method="matmul"),
        "render_state": lambda: step.render_state(scene, state, config),
        "frame (full_trace_step + render_state)": lambda: run_frame(
            scene, config),
    }
    for name, fn in stages.items():
        print(f"stage {name}: {cuda_ms(fn, reps=3):.3f} ms ({tag})")

    check_small_frame(dev)
    check_beer_lambert(dev)

    print(tag)
    print(json.dumps({"kernels": [{
        "name": "splat_product", "route": "cuda",
        "source": "cpm_tpu_torch/csrc/splat_product.cu",
        "replaces": "cpm_tpu/pallas/splat_mxu.py:57",
        "launches": launches, "held_against_plain": True, **kernel}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

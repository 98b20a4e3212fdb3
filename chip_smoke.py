"""On-card smoke run of the PyTorch/CUDA port (``cpm_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero, printing
no result, without them. It imports nothing but the port. In order it:

1. prints the card's name and power limit;
2. builds the three sm_90a libraries from ``cpm_tpu_torch/csrc`` at once,
   one ``nvcc`` each (``splat_product.cu``; ``woodcock_trace.cu`` and
   ``sweep_scan.cu`` with ``--fmad=false``), and prints the build time and
   each compiler's resource report (``-Xptxas -v``: registers, spills);
3. holds both designs of the splat kernel (direct and tiled) against the
   plain PyTorch version, and the binning kernels against the plain
   binning, on seeded inputs with ~30% unused slots at four shapes, which
   between them launch every instantiation the source builds: 262,144
   deposits into 65^3 (the default frame's; windows of 5 cells), 1,000
   into 17x23x29 (windows of 8), 20,000 into 17x23x29 at four times the
   radius (windows of any width: the direct design alone, the tiled one
   keeps no weights for them), and 16,777,216 into 65^3 (the large
   frame's; the plain version once);
4. times both designs in turns (direct, tiled, tiled, direct) at the
   default and the large shape: device time (the kernels' and memsets' own
   time, summed by name from a ``torch.profiler`` window), event-timed bare
   launches through the C entry points, and the event-timed wrapper, each
   beside the bound computed from the inputs; and the device time of both
   at sizes between, which places the wrapper's choice of design;
5. drives the main path through the user's entry points (``init_state`` ->
   ``full_trace_step`` -> ``render_state``) with every kernel's launch
   count set to 0 before and read after, on a scene built with no
   ``device`` argument, which must lie on the card: first the reference's
   interactive workload (a 128^3 smoke cloud, one directional light,
   256 x 256 photons with 4 interactions, a 65^3 light volume, a 512^2
   image), which launches the direct design, then the reference's large
   workload (a 256^3 cloud, 2048 x 2048 photons, a 1024^2 image; traced in
   one piece), which launches the binning and the tiled design; asserts
   for each that the design the wrapper names was launched once, that
   photons were deposited, that light volume and image are finite and the
   image not empty, and that the light volume agrees with the plain splat
   of the frame's own deposits; times both designs in turns on each
   frame's own deposits, and on those of traces at photon counts between,
   which is what the wrapper's threshold is held to; times each stage of
   the default frame with CUDA events;
   Then the trace kernel (``csrc/woodcock_trace.cu``, one launch per
   trace, one thread per lane): it is held against the wavefront loop
   (``method="wavefront"``) lane by lane, bit for bit in at least 99.9%
   of the lanes, with equal statistics and splatted light volumes within
   1e-3 relative L1, on the default frame with each option (float16 at 2
   interactions, no single scattering, ``return_stats``, a 64-slot tape, a
   clip box), in chunks, on one rank's shard of 2 with global lane ids,
   and on a correlated step's retrace of 6,656 lanes with their lane ids
   (later also on a config 4 retrace and config 3's guided frame); both
   are timed in turns (wavefront, kernel, kernel, wavefront) with the
   kernel's device time from ``torch.profiler`` beside its bound; the
   host waits of one trace (none) and of one with ``return_stats`` (one)
   are counted in sync debug mode; a packed ``interactive_frame``
   (``pipeline/packed.py``) is counted, held against the same frame
   through the wavefront loop, its host waits named; and the frame, a
   correlated step and the interactive frame are timed in turns through
   the kernel and through the wavefront loop;
   Then the sweep kernels (``csrc/sweep_scan.cu``: the forward, a plane
   pre-pass and a march, one launch of each per sweep (per chunk of
   planes under ``sweep_scan.PLANE_BUDGET``; every driven sweep is one
   chunk), one thread per intermediate ray; the backward, the pre-pass, a
   gradient march and a fold, one launch of each per chunk of a gradient
   through a sweep), each kernel's registers and the static
   instructions of its plane loop (``scripts/sass_counts.py``, where the
   toolkit has ``cuobjdump``), the planes that the forward's pre-pass left
   in its scratch against their plain version bit for bit at every scan
   checked, and the forward against the plain loop
   (``method="torch"``) on the intermediate images and the image, within
   rtol 1e-4, atol 1e-6 of the largest value, on the default frame, the
   eye-inside camera (two sweeps), rank 1 of 2's columns and a strided
   fifth of them (154, the last block ragged; each equal bit for bit to
   the whole scan's columns), later also on config 3's guided frame, the
   float16 frame and the float16 light volume at 4 interactions, whose
   +inf texels give NaN where the plain loop's products do (NaN held
   equal, the NaN pixels of both images counted and equal), and the frame
   with transfer functions of 17, 64 and 256 points; its device time
   (``torch.profiler``, the pre-pass and the march apart and together)
   beside its bound, and the pre-pass's beside its own byte bound, on the
   frame (at each of those point counts), the eye inside and config 3;
   ``entry.entry``'s
   forward, counted; the backward
   (through ``SweepScan``) against autograd through the plain loop on the
   frame's image loss and tests/test_torch_grad.py's sweep loss, and
   against the plain loop with its plain backward on the frame's image
   loss with the 64-point TF, within rtol 1e-3, atol 1e-5 of each
   gradient's largest component, and alone
   against its plain version (``_scan_planes_grad_torch``) at 4, 17, 64
   and 256 TF points, its fold bit for bit against the fold's plain
   version (``_fold_plane_grads_torch``) on the gradient march's own
   planes, the pre-pass, gradient march and fold timed apart and together
   beside their bounds; render_state, the frame and the interactive frame
   in turns (plain loop, kernels, kernels, plain loop), and the host
   waits of one render in each form (the kernels' no more than the plain
   loop's). Every driven path's launch counts include the sweep kernels:
   the pre-pass and the march once per sweep render, the pre-pass, the
   gradient march and the fold once per gradient through one;
6. drives the correlated update at the default frame, after a
   transfer-function edit (every opacity x 1.5), through ``step()`` with
   the launch counts set to 0 before and read after:
   ``build_importance_grid`` -> ``step(DirtyFlags(tf=True))`` ->
   ``step(DirtyFlags(progressive=True))`` until no flagged photon remains
   -> ``render_state``; asserts that the drain took ceil(flagged / budget)
   batches, that every correlated step launched the splat kernel exactly
   once, and that the image is finite with alpha in (0, 1]. Then: two
   50% batches over a grid of ones must give the light volume of
   ``full_trace_step`` (rtol 1e-3, atol 1e-6 of its peak) and a grid of
   zeros must leave it alone (1e-4); the first batch's signed delta
   deposits (2 x interactions x budget slots) go through both kernel
   designs and the plain version, are timed in turns beside their bound,
   and the design the wrapper chooses there is held to the 10% rule; each
   stage of a correlated step is timed with CUDA events beside
   ``full_trace_step``, with the photons retraced and the places where the
   host waits for the card counted; a small correlated step on the card is
   held against the same step on the CPU (selection equal, light volume
   within 1% relative L1);
   Then, at the default frame: the trace's statistics
   (``return_stats``: photons equal to the run without them, no added host
   wait, the active history's last slot in the last group of flights);
   the importance grid with ``screen_space_weight=0.5`` (equal to base x
   (0.5 + 0.5 x vis), nowhere above base) at the default camera and a
   narrow one, whose drain through ``step()`` (counted) retraces the same
   photons as the unweighted drain, bit for bit; NEE for each light type
   at the frame's deposits (finite, >= 0, zero outside a cone), and the
   box mesh's spans of the light samples against the slab test's; the
   float16 photon storage (the trace cast bit for bit at 4 interactions,
   where some powers overflow to +inf; a counted frame at 2 interactions
   within 2% of float32's, the kernel on its +inf sentinels, a counted
   float16 drain after the TF edit equal to the full retrace on the
   flagged photons, a grid of ones in two batches equal to the full
   trace); a counted frame without single scattering, and the small frame
   without it on the card against the CPU; a counted frame rendered by the
   gather marcher (``render.method="march"``), the dense marcher against
   its loop on 4,096 pixels, the sweep's intermediate image against
   ``march_zplanes_oracle`` on 4,096 rays, both renderers timed in turns,
   and the eye-inside camera at 256^2 (sweep against marcher);
   Then the trajectory gradients at the default frame: the trace with a
   64-slot event tape (photons equal to the trace without it, no lane
   over the cap, no added host wait, timed in turns), the replay (equal
   to the traced powers, rtol 2e-5), a linear image loss through replay
   -> splat (``method="auto"``: the kernel forward and backward) -> sweep
   with its gradients held to an exact difference (light scale, 1e-4),
   finite differences (density, TF colours, 5e-2) and, for the full
   estimator of ``score_grad.trajectory_gradients`` (counted), the Euler
   identity in the light powers (1e-5); the image MSE against a target
   rendered after the TF edit, its full estimator with respect to the TF
   colours on the card against the CPU's from the same photons and tape
   (1e-3); the stages timed, one gradient profiled, peak memory; the
   backward kernel against its plain version and the adjoint identity on
   the frame's deposits and a correlated step's delta list, timed beside
   its bound; and ``examples/fit_tf_torch.py`` on the card (12 steps,
   within 20% of theta, counted);
7. runs one ``correlated_step_scalable`` at the large frame (budget
   419,584), counted, and times both designs on its deposits;
8. drives BASELINE config 4 at full width (bench.py:343-446: a 128^3 x
   32-step orbiting sphere, 256^2 photons x 4 interactions, budget 10%):
   ``VolumeSequence.prepare`` (timed), ``full_trace_step``, then
   ``advance_time`` for t = 1..8, each counted (one splat launch), timed
   in turns with ``full_trace_step`` of the same step and compared with
   it (relative L1, and the stale map's); steps 1 and 2 drained to the end
   with ``correlated_step`` (ceil(flagged / budget) batches, within 1e-3
   of a full retrace); the host waits of one step; the kernel (both
   designs) against the plain version on a step's own signed delta list;
   the stages of a step beside ``full_trace_step``; the statistics of a
   step's retrace; and a small playback (48^3 x 24, 32^2 photons) on the
   card and on the CPU (within 1%);
9. drives BASELINE config 3 (bench.py:173-280: ``ct_head_like(256)``,
   256^2 photons x 4 interactions): an importance-guided frame
   (``init_state(importance_grid=...)`` with ``guided_emission``),
   counted, with the kernel held against the plain version on its
   deposits and its stages timed; a pilot wave, its contribution guide,
   six uniform and six guided waves (bright-cell variance ratio; the
   total-irradiance bias must stay under 0.15); the guided samples as the
   debug image (mean 1); three ticks of ``progressive_step_guided``;
10. drives the default frame with a point, a cone and an area light, and
   with the directional light in Hilbert sample order, each counted and
   held against the plain splat;
   Then the multi-device layer at the default frame, each world from the
   same converted initial state and held against the single-device frame
   (``full_trace_step`` + ``render_state``) from it (photons bit for bit,
   light volume and image within rtol 1e-5, atol 1e-6 of the peak): a
   world of 1 on NCCL in this process (``sharded_full_step``, sweep and
   marcher, counted); a world of 2 gloo processes, both ranks on this card
   (``sharded_full_step``, sweep and marcher; each rank counts its own
   launches, one per step, and prints its trace, splat, all-reduce,
   render and step times); a world of 4 gloo processes as 2 hosts x 2
   chips (``multihost_full_step``, sweep); and the kernel on one rank's
   shard of 2 and of 4 (``splat_all(n_total=)`` against the plain path,
   both designs timed beside the bound). Then BASELINE config 1 through
   ``examples/render_sphere_torch.py``'s body (its printed lines, counted:
   tens of thousands of deposits, alpha max 1, the kernel against the
   plain version on its deposits);
11. runs a small frame (16^3 volume, 32^2 photons, 32^2 pixels) on the
   card and on the CPU, where the tests hold the port against the JAX
   reference, and asserts they agree (relative L1 under 1%);
12. checks the tracer on the card against Beer-Lambert physics in a
   homogeneous volume;
13. prints its wall time, a ``kernels`` JSON line and, last, the device
   JSON line.

A failing phase raises; nothing is caught.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from cpm_tpu_torch import entry as port_entry
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       RenderConfig, SplatConfig,
                                       TracerConfig)
from cpm_tpu_torch.core.lights import CONE, Light
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import TransferFunction, Volume, f32_scalar
from cpm_tpu_torch.io import convert, synthetic
from cpm_tpu_torch.kernels import splat_product as sp
from cpm_tpu_torch.kernels import sweep_scan as ss
from cpm_tpu_torch.kernels import woodcock_trace as wt
from cpm_tpu_torch.ops import (debug, emit, gather, intersect, minmax, mixer,
                               nee, replay, rng, sampling, score_grad,
                               screen_importance, select, splat, sweep_render,
                               tracer)
from cpm_tpu_torch.ops.importance import ImportanceWeights
from cpm_tpu_torch.parallel import multihost as mh
from cpm_tpu_torch.parallel import sharding as psh
from cpm_tpu_torch.pipeline import packed, step
from cpm_tpu_torch.pipeline import timevarying as tv
from cpm_tpu_torch.pipeline.state import DirtyFlags

RTOL = 1e-4  # atomics reorder the fp32 sums: rounding-level differences
ATOL_REL = 1e-6  # absolute tolerance, relative to max |plain|
# Card vs CPU on the same small frame: log/exp round differently on the
# two devices, which can flip a Woodcock decision in a few lanes.
FRAME_REL_L1 = 1e-2
# The -1/+1 update leaves fp32 cancellation residue in the light volume.
# "A drained grid of ones equals a full trace": rtol 1e-3 as the
# reference's own test, and an absolute tolerance of ATOL_REL * max |ref|
# (that test's 1e-3 is 2e-7 of the 4.5e3 peak of its 32^3 scene; the
# default frame's volume peaks near 2.5e5, where one float32 ulp is
# 1.6e-2). "A grid of zeros changes nothing": 1e-4, as the reference's.
DRAINED_RTOL = 1e-3
UNCHANGED_ATOL = 1e-4
OPACITY_EDIT = 1.5  # the transfer-function edit: every opacity times this
# A playback step drained of its flagged photons against a full retrace of
# that step (the reference's tests/test_timevarying.py:88).
DRAINED_PLAYBACK_REL_L1 = 1e-3
# Guided against uniform emission: the total irradiance of six waves each
# (bench.py:242-243; tests/test_guided_emission.py:113).
GUIDED_BIAS = 0.15


def build_frame(device=None, vol_dim=128, photons=256, max_interactions=4,
                width=512, max_steps=6000, fraction=0.1,
                quadrature_samples=8):
    """The reference's interactive workload (its bench.py default):
    smoke_cloud(vol_dim, seed=3), default TFs, one directional light at
    (0, -1, 0.3), the default camera; a correlated update retraces
    ``fraction`` of the photons a batch. With no ``device`` the scene is
    made on the card, as the port's constructors make it."""
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
        recompute=RecomputeConfig(
            max_photons_fraction=fraction,
            importance_quadrature_samples=quadrature_samples),
        render=RenderConfig(width=width, height=width))
    return scene, config


def edit_tf(scene: Scene) -> Scene:
    """The scene after a transfer-function edit: every opacity times
    OPACITY_EDIT, clamped to 1."""
    colors = scene.tf.colors.cpu().numpy().copy()
    colors[:, 3] = np.clip(colors[:, 3] * OPACITY_EDIT, 0.0, 1.0)
    tf = TransferFunction.from_points(scene.tf.positions.cpu().numpy(),
                                      colors, device=scene.device)
    return dataclasses.replace(scene, tf=tf)


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


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per lane (the first axis), True where every element is equal (NaN
    equal to NaN)."""
    eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return eq.reshape(eq.shape[0], -1).all(dim=1)


def trace_lanes_differ(got, want) -> torch.Tensor:
    """(N,) bool: the lanes where two results of ``trace_photons`` differ
    in any bit: a deposit slot's position, power or direction (so the
    deposit count and n_int), the exit power or direction, and, where both
    carry an event tape, its count, types, positions and majorants."""
    gp, gx = got if isinstance(got, tuple) else (got, None)
    wp, wx = want if isinstance(want, tuple) else (want, None)
    same = None
    for f in ("positions", "powers", "directions"):
        eq = _same_bits(getattr(gp, f).transpose(0, 1),
                        getattr(wp, f).transpose(0, 1))
        same = eq if same is None else same & eq
    same &= _same_bits(gp.exit_power[:, None], wp.exit_power[:, None])
    same &= _same_bits(gp.exit_direction, wp.exit_direction)
    if isinstance(gx, tracer.TraceEvents) and isinstance(
            wx, tracer.TraceEvents):
        same &= gx.counts == wx.counts
        for f in ("types", "positions", "majorants"):
            same &= _same_bits(getattr(gx, f), getattr(wx, f))
    return ~same


def seeded_deposits(m: int, seed: int, sentinel_frac: float, device):
    rs = np.random.default_rng(seed)
    pos = rs.random((m, 3), dtype=np.float32)
    pw = rs.random((m, 3), dtype=np.float32)
    unused = rs.random(m, dtype=np.float32) < sentinel_frac
    pos[unused] = np.float32(3.4028235e38)
    pw[unused] = 0.0
    return torch.from_numpy(pos).to(device), torch.from_numpy(pw).to(device)


# Shapes the kernels are held against their plain versions at: the
# default frame's, a ragged one, the ragged one with windows wider than the
# kernels keep weights for, and the large frame's (2048^2 photons x 4
# interactions). width: the instantiation the shape must launch
# (sp.kernel_width). reps: launches per timing window.
RADIUS = 0.0153866
SHAPES = {
    "default": dict(m=262144, dim=(65, 65, 65), r=RADIUS, seed=0, width=5,
                    reps=50),
    "ragged": dict(m=1000, dim=(17, 23, 29), r=0.07, seed=1, width=8,
                   reps=0),
    "wide": dict(m=20000, dim=(17, 23, 29), r=0.14, seed=4, width=0, reps=0),
    "large": dict(m=16777216, dim=(65, 65, 65), r=RADIUS, seed=2, width=5,
                  reps=5),
}
# Sizes between the two, timed to place the threshold of the design choice:
# seeded deposit counts, and photons per axis of traced frames.
BETWEEN = (524288, 1048576, 4194304)
BETWEEN_PHOTONS = (362, 512, 1024, 1448, 1774)
TURNS = ("direct", "tiled", "tiled", "direct")
CHOICE_SLACK = 0.10  # the chosen design may be this much slower than the other
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOP_PER_S = 67e12  # H100 SXM, published, outside the tensor cores

DESIGNS = {"direct": sp.splat_product_direct,
           "tiled": sp.splat_product_tiled}


# What one call enqueues, by the name its profiler record starts with or
# holds (csrc/splat_product.cu: cpm_splat_direct, cpm_bin_deposits,
# cpm_splat_tiled after a binning).
_BIN_RECORDS = {"Memset": 1, "bin_count_kernel": 1, "bin_scan_kernel": 1,
                "bin_fill_kernel": 1}
RECORDS = {"direct": {"Memset": 1, "splat_direct_kernel": 1},
           "grad": {"splat_grad_kernel": 1},
           "bin": _BIN_RECORDS,
           "tiled": {**_BIN_RECORDS, "Memset": 2, "splat_tiled_kernel": 1}}
# Profiler windows by outcome ("complete", "short", "retaken") and the
# records the short ones lacked, by name.
WINDOWS = collections.Counter()
MISSING = collections.Counter()


def device_ms(what: str, fn, reps: int, by_name: bool = False):
    """Mean device milliseconds per call of ``fn``, which enqueues
    RECORDS[what]: the device time of those kernels and memsets in a
    ``torch.profiler`` window over ``reps`` calls (with ``by_name``, a dict
    of each name's). A complete window holds
    reps x RECORDS[what] records, and the result is their sum over
    ``reps``. From some point of a long run on, the profiler loses the
    first one or two records of every window (a memset, the kernel after
    it), and now and then a longer stretch; a name's time in such a short
    window is the mean of its records that are there, times its known
    launches per call. A window with no record of some name, or with a
    kernel's record under half or over twice that kernel's median, is
    printed and taken again, four times at most. Raises where a window
    holds more records than were enqueued; 0.0 when four windows in a row
    show no device time at all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    want = {name: reps * per for name, per in RECORDS[what].items()}
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {name: [] for name in want}
        for e in prof.events():
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            for name in seen:
                if t > 0.0 and (e.name.startswith(name) if name == "Memset"
                                else name in e.name):
                    seen[name].append(t)
        counts = {name: len(us) for name, us in seen.items()}
        if any(counts[name] > want[name] for name in want):
            raise AssertionError(f"{what}: the window holds the records "
                                 f"{counts}, more than the {want} enqueued")
        odd = {name: [round(t, 1) for t in us] for name, us in seen.items()
               if us and name != "Memset"
               and not 0.5 * statistics.median(us) < min(us) <= max(us)
               < 2.0 * statistics.median(us)}
        if all(counts.values()) and not odd:
            WINDOWS["complete" if counts == want else "short"] += 1
            MISSING.update({name: want[name] - counts[name] for name in want
                            if counts[name] < want[name]})
            per = {name: statistics.fmean(us) * RECORDS[what][name] / 1e3
                   for name, us in seen.items()}
            return per if by_name else sum(per.values())
        WINDOWS["retaken"] += 1
        print(f"profiler window of {reps} x {what} taken again: records "
              f"{counts} of {want}; odd microseconds {odd}")
    if any(counts.values()):
        raise AssertionError(f"{what}: four profiler windows in a row are "
                             "unusable")
    return {name: 0.0 for name in want} if by_name else 0.0


def bare_launcher(design: str, pos, pw, r: float, dim):
    """A closure that enqueues one splat of the design through the
    library's C entry points alone, into preallocated output and scratch:
    what the wrapper launches, without the wrapper."""
    lib = sp._library()
    r = float(np.float32(r))
    inv_r = float(sp.inverse_radius(r))
    d, h, w = dim
    m = pos.shape[0]
    out = torch.empty((d, h, w, 3), dtype=torch.float32, device=pos.device)
    width = sp.kernel_width(r, dim)
    stream = torch.cuda.current_stream().cuda_stream
    if design == "direct":
        def launch():
            err = lib.cpm_splat_direct(pos.data_ptr(), pw.data_ptr(), m, r,
                                       inv_r, d, h, w, width,
                                       out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"CUDA error {err}")
        return launch
    items = sp.max_work_items(m, dim)
    meta = torch.empty(3 * sp.brick_count(dim) + 2 + 3 * items,
                       dtype=torch.int32, device=pos.device)
    order = torch.empty(m, dtype=torch.int32, device=pos.device)

    def launch():
        err = lib.cpm_bin_deposits(pos.data_ptr(), m, sp.count_chunk(m),
                                   sp.SEGMENT, d, h, w, meta.data_ptr(),
                                   order.data_ptr(), stream)
        err = err or lib.cpm_splat_tiled(
            pos.data_ptr(), pw.data_ptr(), order.data_ptr(), meta.data_ptr(),
            items, r, inv_r, d, h, w, sp.halo_cells(r, dim), width,
            out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"CUDA error {err}")
    return launch


def splat_bound(pos, pw, r: float, dim) -> dict:
    """The least time the card could take for this splat: bytes (every
    slot's 12 of position and every used slot's 12 of power read once, the
    grid's 12 a cell written once) over the memory rate against the
    operations this data needs (6 per weight of a cell inside a support, 9
    per nonzero term) over the fp32 rate."""
    m = pos.shape[0]
    live = int((pos[:, 0] < 1e30).sum())
    byts = 12 * m + 12 * live + 12 * dim[0] * dim[1] * dim[2]
    inv_r = float(sp.inverse_radius(r))
    weights = terms = 0
    for lo in range(0, m, 1 << 20):
        p = pos[lo:lo + (1 << 20)]
        nz = []
        for axis, n in ((2, dim[0]), (1, dim[1]), (0, dim[2])):
            c = sp.voxel_centres(n, pos.device)
            dist = (c[None, :] - p[:, axis, None]) * inv_r
            nz.append((dist * dist < 1.0).sum(1))
        weights += int((nz[0] + nz[1] + nz[2]).sum())
        terms += int((nz[0] * nz[1] * nz[2]).sum())
    flop = 6 * weights + 9 * terms
    by_bytes, by_ops = byts / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": byts, "flop": flop, "weights": weights,
            "nonzero_terms": terms}


def check_binning(pos, dim, what: str) -> int:
    """The binning kernels against their plain version: counts and offsets
    equal, every entry of a brick's segment a deposit of that brick, and
    the segments together the live deposits exactly once each. Returns the
    largest difference it saw between the kernels' integers (counts,
    offsets, sorted segment entries) and the plain version's; raises
    unless that is 0."""
    meta, order = sp.bin_deposits(pos, dim)
    torch.cuda.synchronize()
    counts, offsets, want_order = sp.bin_deposits_torch(pos, dim)
    nb = sp.brick_count(dim)
    err = max(int((meta[:nb] - counts).abs().max()),
              int((meta[2 * nb:3 * nb + 1] - offsets).abs().max()))
    if err:
        raise AssertionError(f"{what}: brick counts or offsets differ by up "
                             f"to {err}")
    live = int(offsets[-1])
    got = order[:live].long()
    if live and not (0 <= int(got.min()) and int(got.max()) < pos.shape[0]):
        raise AssertionError(f"{what}: an index outside the deposits")
    want_keys = torch.repeat_interleave(
        torch.arange(nb, device=pos.device), counts)
    if not torch.equal(sp.brick_keys(pos, dim)[got], want_keys):
        raise AssertionError(f"{what}: a deposit lies in another brick's "
                             "segment")
    if live:
        err = int((torch.sort(got).values
                   - torch.sort(want_order).values).abs().max())
    if err:
        raise AssertionError(f"{what}: the segments do not hold every live "
                             "deposit exactly once")
    n_items = int(meta[3 * nb + 1])
    work = meta[3 * nb + 2:3 * nb + 2 + 3 * n_items].reshape(-1, 3).long()
    want_items = int(((counts + sp.SEGMENT - 1) // sp.SEGMENT).sum())
    sizes = work[:, 2] - work[:, 1]
    if n_items != want_items or int(sizes.sum()) != live or not bool(
            ((sizes > 0) & (sizes <= sp.SEGMENT)).all()) or not torch.equal(
                want_keys[work[:, 1]], work[:, 0]):
        raise AssertionError(f"{what}: the work items do not cut the "
                             "segments")
    print(f"binning vs plain, {what}: {live} live deposits in "
          f"{int((counts > 0).sum())} of {nb} bricks, {n_items} work items: "
          f"max_abs_err {err}")
    return err


def timed_once(fn):
    """(fn's result, its milliseconds from CUDA events), one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_design(design: str, pos, pw, r, dim, reps: int) -> dict:
    fn = DESIGNS[design]
    dev = device_ms(design, lambda: fn(pos, pw, r, dim), reps)
    bare = cuda_ms(bare_launcher(design, pos, pw, r, dim), max(reps, 200)
                   if pos.shape[0] <= 1 << 20 else reps)
    wrapper = cuda_ms(lambda: fn(pos, pw, r, dim), reps)
    if dev == 0.0:
        print("torch.profiler showed no device time; the kernel's time is "
              "the event-timed run of bare launches")
    return {"ms": dev if dev > 0.0 else bare, "profiler_ms": dev,
            "bare_ms": bare, "wrapper_ms": wrapper}


def check_kernels(dev, tag) -> dict:
    """Every design against the plain version at every shape, the binning
    against its plain version, and both designs timed in turns (direct,
    tiled, tiled, direct) at the default and the large shape with the
    bound beside each. Returns {shape: {...}}."""
    results = {}
    for name, shape in SHAPES.items():
        m, dim, r = shape["m"], shape["dim"], shape["r"]
        what = f"{m} deposits -> {'x'.join(map(str, dim))}"
        pos, pw = seeded_deposits(m, shape["seed"], 0.3, dev)
        ref, plain_once = timed_once(
            lambda: sp.splat_product_torch(pos, pw, r, dim))
        res = {"m": m, "dim": dim, "chosen": sp.choose_design(m, r, dim),
               "max_abs_err": {}, **splat_bound(pos, pw, r, dim)}
        if sp.kernel_width(r, dim) != shape["width"]:
            raise AssertionError(f"{what}: windows of width "
                                 f"{sp.kernel_width(r, dim)}, not the "
                                 f"{shape['width']} this shape is here for")
        for design, fn in DESIGNS.items():
            if design == "tiled" and not sp.tiled_fits(r, dim):
                if res["chosen"] != "direct":
                    raise AssertionError(f"{what}: the tiled design does "
                                         "not fit and was chosen")
                print(f"splat tiled, {what}: does not fit, not launched")
                continue
            got = fn(pos, pw, r, dim)
            torch.cuda.synchronize()
            res["max_abs_err"][design] = compare(
                got, ref, f"splat {design} vs plain, {what}")
            del got
        del ref
        res["bin_max_abs_err"] = check_binning(pos, dim, what)
        reps = shape["reps"]
        if reps:
            res["plain_ms"] = (cuda_ms(lambda: sp.splat_product_torch(
                pos, pw, r, dim), reps=5) if m <= 1 << 20 else plain_once)
            runs = [(d, time_design(d, pos, pw, r, dim, reps))
                    for d in TURNS]
            for design, t in runs:
                print(f"splat {design} at {what}: device {t['ms']:.4f} ms, "
                      f"bare launches {t['bare_ms']:.4f} ms, wrapper "
                      f"{t['wrapper_ms']:.4f} ms; bound "
                      f"{res['bound_ms']:.4f} ms ({res['bound_by']}), share "
                      f"{res['bound_ms'] / t['ms']:.3f}; plain "
                      f"{res['plain_ms']:.3f} ms ({tag})")
            res["runs"] = [{"design": d, **t} for d, t in runs]
            res["bin"] = {
                "ms": device_ms("bin", lambda: sp.bin_deposits(pos, dim),
                                reps),
                "wrapper_ms": cuda_ms(
                    lambda: sp.bin_deposits(pos, dim), reps),
                "plain_ms": cuda_ms(
                    lambda: sp.bin_deposits_torch(pos, dim), 2),
                "bound_ms": (12 * m + 4 * int(
                    (pos[:, 0] < 1e30).sum())) / HBM_BYTES_PER_S * 1e3}
            print(f"binning at {what}: device {res['bin']['ms']:.4f} ms, "
                  f"wrapper {res['bin']['wrapper_ms']:.4f} ms, plain "
                  f"{res['bin']['plain_ms']:.3f} ms, bound "
                  f"{res['bin']['bound_ms']:.4f} ms (bytes) ({tag})")
        results[name] = res
        del pos, pw
    for m in BETWEEN:
        pos, pw = seeded_deposits(m, 3, 0.3, dev)
        dim = SHAPES["default"]["dim"]
        times = [(d, device_ms(d, lambda: DESIGNS[d](pos, pw, RADIUS, dim),
                               10)) for d in TURNS]
        print(f"splat at {m} seeded deposits -> 65x65x65 "
              f"({m / math.prod(dim):.2f} a cell): "
              + ", ".join(f"{d} {t:.4f} ms" for d, t in times) + f" ({tag})")
        results[f"between_{m}"] = times
        del pos, pw
    torch.cuda.empty_cache()
    return results


def rel_l1(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want.cpu()).abs().sum() / want.abs().sum())


def with_tracer(config, **options):
    return dataclasses.replace(config, tracer=dataclasses.replace(
        config.tracer, **options))


def with_render(config, **options):
    return dataclasses.replace(config, render=dataclasses.replace(
        config.render, **options))


def check_small_frame(dev, **options) -> None:
    """The same small frame on the card and on the CPU, with the tracer
    ``options`` given."""
    small = dict(vol_dim=16, photons=32, max_interactions=2, width=32)
    runs = []
    for device in (None, "cpu"):
        scene, config = build_frame(device, **small)
        runs.append(run_frame(scene, with_tracer(config, **options)))
    (gpu_state, gpu_img), (cpu_state, cpu_img) = runs
    if gpu_img.device != dev or cpu_img.device.type != "cpu":
        raise AssertionError("a small frame ran on another device than asked")
    lv_err = rel_l1(gpu_state.light_volume, cpu_state.light_volume)
    img_err = rel_l1(gpu_img, cpu_img)
    print(f"small frame{f' {options}' if options else ''}, card vs CPU: "
          f"light volume rel L1 {lv_err:.3e}, image rel L1 {img_err:.3e}")
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


COUNTED = {"splat_product_direct": sp.splat_product_direct,
           "splat_product_tiled": sp.splat_product_tiled,
           "bin_deposits": sp.bin_deposits}


TRACE = wt.trace_woodcock_cuda  # the trace kernel's wrapper
# The sweep kernels' wrappers: the forward's plane pre-pass and its march
# once per sweep (two for an eye inside the volume's slab range; one of
# each per chunk of planes, and every driven sweep is one chunk), the
# backward's pre-pass, gradient march and fold once per gradient.
SWEEP_PREP = ss.sweep_planes
SWEEP_FWD, SWEEP_BWD = ss.sweep_scan_forward, ss.sweep_scan_backward
SWEEP_FOLD = ss.sweep_fold


def reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in (*COUNTED.values(), sp.splat_product_grad_cuda, TRACE,
               SWEEP_PREP, SWEEP_FWD, SWEEP_BWD, SWEEP_FOLD):
        fn.launches = 0


def read_counts() -> dict:
    return {**{name: fn.launches for name, fn in COUNTED.items()},
            "trace_woodcock_cuda": TRACE.launches,
            "sweep_planes": SWEEP_PREP.launches,
            "sweep_scan_forward": SWEEP_FWD.launches,
            "sweep_scan_backward": SWEEP_BWD.launches,
            "sweep_fold": SWEEP_FOLD.launches}


def expect_launches(what: str, launches: dict, designs: list,
                    traces: int | None = None, sweeps: int = 0,
                    sweep_grads: int = 0) -> None:
    """Raise unless the splat kernels were launched once for each entry of
    ``designs`` ("direct" or "tiled", with one binning per tiled launch)
    and no more, the trace kernel ``traces`` times (one trace per splat
    unless given), the sweep's forward kernels (the plane pre-pass and the
    march) ``sweeps`` times and its backward's (the pre-pass, the gradient
    march and the fold) ``sweep_grads`` times: every driven path traces
    and renders through the kernels."""
    want = {"splat_product_direct": designs.count("direct"),
            "splat_product_tiled": designs.count("tiled"),
            "bin_deposits": designs.count("tiled"),
            "trace_woodcock_cuda": len(designs) if traces is None else traces,
            "sweep_planes": sweeps + sweep_grads,
            "sweep_scan_forward": sweeps,
            "sweep_scan_backward": sweep_grads,
            "sweep_fold": sweep_grads}
    if launches != want:
        raise AssertionError(f"{what}: expected the launches {want}, "
                             f"counted {launches}")


def time_on_deposits(what: str, photons, dim, reps: int, tag) -> dict:
    """Both designs in turns on the deposits a trace left, as ``splat_all``
    hands them to the kernel: device time beside the bound."""
    pos, pw = splat.product_deposits(photons)
    return time_on_list(what, pos, pw, photons.radius_rel, dim, reps, tag)


def time_on_list(what: str, pos, pw, r: float, dim, reps: int, tag) -> dict:
    """Both designs in turns on one deposit list: device time beside the
    bound, the design the wrapper chooses for it and the faster one. A
    design whose two turns differ by over 15% (the profiler can lose a
    window's records) gets a third; its time is the median."""
    m = pos.shape[0]
    bound = splat_bound(pos, pw, r, dim)

    def run(design):
        t = device_ms(design, lambda: DESIGNS[design](pos, pw, r, dim),
                      reps)
        if t == 0.0:
            raise AssertionError("torch.profiler showed no device time")
        return t

    runs = [(d, run(d)) for d in TURNS]
    for d in DESIGNS:
        a, b = (t for e, t in runs if e == d)
        if max(a, b) > 1.15 * min(a, b):
            runs.append((d, run(d)))
    res = {"deposits": m, "live": int((pos[:, 0] < 1e30).sum()),
           "per_cell": m / math.prod(dim),
           "chosen": sp.choose_design(m, r, dim),
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           **{d: [t for e, t in runs if e == d] for d in DESIGNS}}
    res["median_ms"] = {d: statistics.median(res[d]) for d in DESIGNS}
    res["faster"] = min(DESIGNS, key=res["median_ms"].get)
    print(f"splat on the deposits of {what}: {m} slots ({res['live']} live, "
          f"{res['per_cell']:.2f} slots and "
          f"{res['live'] / math.prod(dim):.2f} live a cell) -> {dim}: "
          + ", ".join(f"{d} {t:.4f} ms" for d, t in runs)
          + f"; bound {res['bound_ms']:.4f} ms ({res['bound_by']}); chosen "
          f"{res['chosen']}, faster {res['faster']} ({tag})")
    return res


def between_frames(tag) -> dict:
    """Traces of the default scene at photon counts between the default
    and the large frame's: both designs on their deposits."""
    out = {}
    for photons in BETWEEN_PHOTONS:
        scene, config = build_frame(photons=photons)
        state = step.full_trace_step(scene, step.init_state(scene, config),
                                     config)
        out[str(photons)] = time_on_deposits(
            f"a trace of {photons}^2 photons", state.photons,
            step.light_volume_shape(config), 10, tag)
        del scene, state
    torch.cuda.empty_cache()
    return out


def expect_frame(what: str, config, state, img, dev, launches) -> None:
    """A frame's checks: the kernel launched once in the design the wrapper
    names for its slots, photons deposited, light volume and image on the
    card, finite, the image not empty, and the light volume equal to the
    plain splat of the frame's own deposits."""
    slots = state.photons.positions.shape[0] * state.photons.positions.shape[1]
    dim = step.light_volume_shape(config)
    expect_launches(what, launches, [sp.choose_design(
        slots, state.photons.radius_rel, dim)],
        sweeps=int(config.render.method == "sweep"))
    deposited = int((state.photons.positions[..., 0] < 1e30).sum())
    lv = state.light_volume
    alpha = float(img[..., 3].max())
    print(f"{what}: deposited photons {deposited}, light volume sum "
          f"{float(lv.sum()):.6g}, image alpha max {alpha:.4f}, launches "
          f"{launches}")
    if lv.device != dev or img.device != dev:
        raise AssertionError(f"{what}: the frame left the card")
    if deposited <= 0:
        raise AssertionError(f"{what}: no photon was deposited")
    if not (bool(torch.isfinite(lv).all()) and bool(torch.isfinite(img).all())):
        raise AssertionError(f"{what}: non-finite light volume or image")
    side = config.render.width
    if img.shape != (side, side, 4) or alpha <= 0.0:
        raise AssertionError(f"{what}: empty or misshapen image")
    compare(lv, splat.splat_all(state.photons, dim, method="matmul"),
            f"{what}: light volume (kernel) vs plain splat")


def counted_frame(what: str, dev, tag, reps: int, **frame) -> tuple:
    """Drive the main path once with every kernel's count set to 0 just
    before and read just after; the scene is built with no ``device``
    argument and must lie on the card. Returns (scene, config, state,
    image, launches by kernel, both designs' times on the frame's own
    deposits)."""
    scene, config = build_frame(**frame)
    if scene.device != dev:
        raise AssertionError(f"a scene built with no device lies on "
                             f"{scene.device}, not on {dev}")
    reset_counts()
    t0 = time.perf_counter()
    state, img = run_frame(scene, config)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    slots = state.photons.positions.shape[0] * state.photons.positions.shape[1]
    dim = step.light_volume_shape(config)
    design = sp.choose_design(slots, config.tracer.radius_rel, dim)
    print(f"{what} (first run, includes warm-up): {ms:.1f} ms; {slots} "
          f"deposit slots -> {dim}, design {design}, launches {launches} "
          f"({tag})")
    expect_frame(what, config, state, img, dev, launches)
    on_own = time_on_deposits(f"the {what}", state.photons, dim, reps, tag)
    return scene, config, state, img, launches, on_own


# --- the trace kernel -----------------------------------------------------

# The trace kernel against the wavefront loop on the card: at most this
# share of a list's lanes may differ in any bit of a deposit, an exit or
# the tape (expected 0: the kernel rounds as torch's operators do,
# --fmad=false), and the light volumes splatted from the two traces agree
# within this relative L1.
TRACE_MAX_LANES_DIFFER = 1e-3
TRACE_LV_REL_L1 = 1e-3
TRACE_TURNS = ("wavefront", "cuda", "cuda", "wavefront")
RETRACE_LANES = 6656  # a default correlated step's budget (10% of 65,536)
TRACE_CHUNK = 16384
CLIP_BOX = dict(clip_min=(0.1, 0.0, 0.2), clip_max=(0.9, 1.0, 0.8))
RECORDS["trace"] = {"woodcock_trace_kernel": 1}


@contextlib.contextmanager
def traced_by(method: str):
    """Every trace of the pipeline through ``method`` while inside: the
    twin path (``"wavefront"``), timed beside the kernel's."""
    saved = tracer.trace_photons, tracer.trace_photons_chunked
    tracer.trace_photons = functools.partial(saved[0], method=method)
    tracer.trace_photons_chunked = functools.partial(saved[1], method=method)
    try:
        yield
    finally:
        tracer.trace_photons, tracer.trace_photons_chunked = saved


def trace_bound(c, n: int, flights: int, tape: int) -> dict:
    """The least time of one trace on the card, the larger of: the bytes
    it must move (the volume, the majorant and distance grids, the light
    samples (44 B), the lane ids (8 B), the deposit slots (32 B each), the
    exits (12 B) and the tape (20 B a slot)) at HBM_BYTES_PER_S, and its
    operations (the active lane-flights this run's data needs, times
    ``woodcock_trace.OPS_PER_FLIGHT``) at FP32_FLOP_PER_S."""
    vol = math.prod(c.shape) * 4 + 2 * c.maj.numel() * 4
    nbytes = vol + n * (44 + 8 + 12 + 20 * tape) \
        + c.max_interactions * n * 32
    ops = flights * wt.OPS_PER_FLIGHT
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "operations": ops,
            "active_lane_flights": flights,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_trace(what: str, scene, samples, key, tcfg, dim, tag, *,
                lane_ids=None, chunk=None, timed=False, **opts) -> dict:
    """The trace kernel against the wavefront loop on one list of light
    samples, through ``trace_photons`` (or ``trace_photons_chunked`` in
    chunks of ``chunk``) with ``method`` named: lanes that differ in any
    bit (at most TRACE_MAX_LANES_DIFFER of them), the statistics equal
    where asked for, the light volumes splatted from both within
    TRACE_LV_REL_L1, one launch per trace (per chunk). With ``timed``,
    both in turns (TRACE_TURNS, CUDA events around the whole call), the
    kernel's device time (``torch.profiler``) and its bound."""
    args = (scene.volume, scene.tf, scene.tf_scattering, samples, key, tcfg)

    def trace(method, **kw):
        if chunk:
            return tracer.trace_photons_chunked(*args, chunk,
                                                lane_ids=lane_ids,
                                                method=method)
        return tracer.trace_photons(*args, lane_ids=lane_ids, method=method,
                                    **{**opts, **kw})

    n = samples.n
    torch.cuda.synchronize()
    before = TRACE.launches
    got = trace("cuda")
    torch.cuda.synchronize()
    launches = TRACE.launches - before
    want = trace("wavefront")
    torch.cuda.synchronize()
    if TRACE.launches - before != launches or launches != (
            -(-n // chunk) if chunk else 1):
        raise AssertionError(f"{what}: {launches} kernel launches")
    differ = int(trace_lanes_differ(got, want).sum())
    gp, wp = (r[0] if isinstance(r, tuple) else r for r in (got, want))
    lv_got = splat.splat_all(gp, dim, method="cuda")
    lv_want = splat.splat_all(wp, dim, method="cuda")
    err = rel_l1(lv_got, lv_want)
    abs_err = float((lv_got - lv_want).abs().max())
    deposited = int(used_slots(gp).sum())
    msg = ""
    stats_equal = True
    if opts.get("return_stats"):
        g, w = got[1], want[1]
        stats_equal = (g["wavefront_iters"] == w["wavefront_iters"]
                       and torch.equal(g["active_history"],
                                       w["active_history"])
                       and torch.equal(g["mean_active_frac"],
                                       w["mean_active_frac"])
                       and g["stage_widths"] == w["stage_widths"])
        msg = (f"; statistics equal {stats_equal} ({g['wavefront_iters']} "
               f"flights, mean active fraction "
               f"{float(g['mean_active_frac']):.6f})")
    if opts.get("record_events"):
        msg += f"; {int(got[1].counts.sum())} tests on the tape"
    print(f"trace kernel vs wavefront, {what}: {differ} of {n} lanes differ "
          f"in any bit, {deposited} deposits, light volume rel L1 "
          f"{err:.3e}, {launches} launch(es){msg} ({tag})")
    if differ > TRACE_MAX_LANES_DIFFER * n or not err <= TRACE_LV_REL_L1 \
            or not stats_equal or deposited <= 0:
        raise AssertionError(f"{what}: the kernel disagrees with the "
                             "wavefront loop")
    res = {"lanes": n, "lanes_differing": differ, "deposits": deposited,
           "light_volume_rel_l1": err, "max_abs_err": abs_err,
           "launches": launches}
    if not timed:
        return res
    runs = [(m, cuda_ms(lambda m=m: trace(m), reps=2)) for m in TRACE_TURNS]
    dev_ms = device_ms("trace", lambda: trace("cuda"), reps=3)
    if dev_ms == 0.0:
        raise AssertionError("torch.profiler showed no device time")
    _, stats = trace("cuda", return_stats=True)
    flights = int(stats["active_history"].sum())
    c = tracer.trace_constants(scene.volume, scene.tf, scene.tf_scattering,
                               tcfg)
    bound = trace_bound(c, n, flights, opts.get("record_events", 0))
    plain = statistics.median(t for m, t in runs if m == "wavefront")
    call = statistics.median(t for m, t in runs if m == "cuda")
    print(f"trace {what}: in turns " + ", ".join(
        f"{m} {t:.3f} ms" for m, t in runs)
        + f"; kernel device time {dev_ms:.4f} ms, bound {bound['bound_ms']:.4f}"
        f" ms ({bound['bound_by']}: {bound['bytes']} B, "
        f"{bound['active_lane_flights']} active lane-flights, "
        f"{stats['wavefront_iters']} flights) ({tag})")
    res.update({"ms": dev_ms, "call_ms": call, "plain_ms": plain,
                "in_turns": runs, "flights": stats["wavefront_iters"],
                "mean_active_frac": float(stats["mean_active_frac"]),
                **bound})
    return res


def trace_kernel_phase(scene, config, state, dev, tag) -> dict:
    """The trace kernel at the default frame: the compiler's report; the
    kernel against the wavefront loop, lane by lane, with each option
    (float16 at 2 interactions, no single scattering, the statistics, a
    64-slot tape), on a correlated step's retrace of 6,656 lanes with their
    lane ids, with a clip box, in chunks, and on one rank's shard of 2
    with global lane ids; the default frame's and the retrace's times in
    turns with the wavefront; the host waits of one trace (none) and with
    the statistics (one, the read of the flights); then frames, a
    correlated step and a packed interactive frame through the kernel and
    through the wavefront loop in turns, and the host waits of one
    interactive frame, each named."""
    t0 = time.perf_counter()
    dim = step.light_volume_shape(config)
    samples = state.light_samples
    key = rng.fold_in(state.key, 0)
    tc = config.tracer
    res = {}
    res["default frame"] = check_trace(
        "default frame (65536 lanes x 4 interactions, 128^3)", scene,
        samples, key, tc, dim, tag, timed=True)
    for name, extra, opts in (
            ("float16, 2 interactions",
             dict(photon_dtype="float16", max_interactions=2), {}),
            ("no single scattering", dict(no_single_scattering=True), {}),
            ("return_stats", {}, dict(return_stats=True)),
            (f"{GRAD_TAPE}-slot tape", {}, dict(record_events=GRAD_TAPE)),
            ("clip box", CLIP_BOX, {})):
        res[name] = check_trace(f"default frame, {name}", scene, samples,
                                key, dataclasses.replace(tc, **extra), dim,
                                tag, **opts)
    res["chunked"] = check_trace(
        f"default frame in chunks of {TRACE_CHUNK}", scene, samples, key, tc,
        dim, tag, chunk=TRACE_CHUNK)
    half = samples.n // 2
    shard = dataclasses.replace(
        samples, origins=samples.origins[half:],
        directions=samples.directions[half:], powers=samples.powers[half:],
        tspan=samples.tspan[half:])
    res["shard"] = check_trace(
        "rank 1's shard of 2 (global lane ids)", scene, shard, key, tc, dim,
        tag, lane_ids=torch.arange(half, samples.n, device=dev))

    # A correlated step's retrace: the first batch after the TF edit (the
    # step's own selection), its lanes' own ids, on the edited scene.
    edited = edit_tf(scene)
    grid = step.build_importance_grid(edited, config)
    first = step.step(edited, state, config, DirtyFlags(tf=True), grid)
    budget = step.recompute_budget(config, samples.n)
    imp = step.recompute_importance(config, grid, state.photons, samples)
    indices, valid, _ = select.select_photons_to_recompute(imp, budget)
    sub, safe = step.selected_samples(samples, indices, valid)
    if sub.n != RETRACE_LANES:
        raise AssertionError(f"a batch of {sub.n} lanes")
    res["retrace"] = check_trace(
        f"retrace of {RETRACE_LANES} lanes (their lane ids)", edited, sub,
        key, tc, dim, tag, lane_ids=safe, timed=True)

    # Host waits of one trace, by source line.
    waits = {}
    for name, opts in (("trace", {}), ("trace with return_stats",
                                       dict(return_stats=True))):
        waits[name] = host_waits(lambda opts=opts: tracer.trace_photons(
            scene.volume, scene.tf, scene.tf_scattering, samples, key, tc,
            **opts))
        print(f"host waits of one {name} on the kernel path: "
              f"{sum(waits[name].values())} ("
              + (", ".join(f"{w} x{c}" for w, c in waits[name].items())
                 or "none") + f") ({tag})")
    if sum(waits["trace"].values()) != 0 or sum(
            waits["trace with return_stats"].values()) > 1:
        raise AssertionError("the kernel path waits for the card")

    # End to end, kernel against the twin path, in turns.
    packed_state = packed.pack_state(state)

    def frame():
        return run_frame(scene, config)

    def correlated():
        return step.step(edited, state, config, DirtyFlags(tf=True), grid)

    def interactive():
        return packed.interactive_frame(edited, packed_state, scene.camera,
                                        grid, config, budget,
                                        fresh_round=True)

    reset_counts()
    got, img = interactive()
    torch.cuda.synchronize()
    launches = read_counts()
    expect_launches("interactive_frame", launches, [sp.choose_design(
        2 * tc.max_interactions * budget, f32_scalar(tc.radius_rel), dim)],
        sweeps=1)
    with traced_by("wavefront"):
        want, want_img = interactive()
    after = packed.unpack_state(got)
    differ = int(_same_bits(got.photon_soa.transpose(0, 1),
                            want.photon_soa.transpose(0, 1)).logical_not()
                 .sum())
    lv_err = rel_l1(got.light_volume, want.light_volume)
    print(f"interactive_frame, kernel vs wavefront: {differ} of "
          f"{samples.n} lanes differ in any bit, light volume rel L1 "
          f"{lv_err:.3e}, image max_abs_err "
          f"{float((img - want_img).abs().max()):.3e} ({tag})")
    if (differ > TRACE_MAX_LANES_DIFFER * samples.n
            or not lv_err <= TRACE_LV_REL_L1
            or after.n_remaining != first.n_remaining
            or not torch.equal(after.retraced, first.retraced)
            or not bool(torch.isfinite(img).all())):
        raise AssertionError("interactive_frame: the kernel's frame is not "
                             "the wavefront's")
    frame_waits = host_waits(interactive)
    step_waits = host_waits(correlated)
    print(f"interactive_frame: launches {launches}; host waits "
          f"{sum(frame_waits.values())} ("
          + ", ".join(f"{w} x{c}" for w, c in frame_waits.items())
          + f"); a correlated step through step() "
          f"{sum(step_waits.values())} ({tag})")
    turns = {}
    for name, fn in (("frame (full_trace_step + render_state)", frame),
                     ("correlated_step (step(), TF edit)", correlated),
                     ("interactive_frame", interactive)):
        runs = []
        for m in TRACE_TURNS:
            with traced_by(m):
                runs.append((m, cuda_ms(fn, reps=2)))
        turns[name] = runs
        print(f"{name} in turns: " + ", ".join(
            f"{m} {t:.3f} ms" for m, t in runs) + f" ({tag})")
    print(f"the trace kernel phase took {time.perf_counter() - t0:.1f} s")
    return {"lists": res, "host_waits": {k: dict(v) for k, v in
                                         waits.items()},
            "interactive_frame": {"launches": launches,
                                  "host_waits": dict(frame_waits),
                                  "correlated_step_host_waits":
                                      dict(step_waits)},
            "end_to_end_in_turns": turns}


def trace_row(phase: dict, main_launches: int, extra: dict) -> dict:
    """The ``kernels`` row of the trace kernel: its numbers at the default
    frame, launches from the counted default frame, every list's
    comparison and the other lists' times under ``lists``."""
    d = phase["lists"]["default frame"]
    return {
        "name": "trace_woodcock_cuda", "route": "cuda",
        "source": "cpm_tpu_torch/csrc/woodcock_trace.cu",
        "replaces": "cpm_tpu/ops/tracer.py:255",
        "replaces_note": "no Pallas kernel: the lax.while_loop of "
                         "trace_photons (:255-601) with its brick table "
                         "and staged compaction",
        "caller": "full_trace_step (default frame), and every trace",
        "launches": main_launches, "held_against_plain": True,
        "max_abs_err": d["max_abs_err"],
        "max_abs_err_of": "the light volume splatted from the kernel's "
                          "trace against the wavefront's",
        "lanes_differing": d["lanes_differing"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "call_ms": d["call_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": None, "lists": {**phase["lists"], **extra},
        "host_waits": phase["host_waits"],
        "interactive_frame": phase["interactive_frame"],
        "end_to_end_in_turns": phase["end_to_end_in_turns"]}


# --- the sweep's plane scan -----------------------------------------------

# The sweep kernels against the plain loop on the card. The forward to
# rtol 1e-4, atol 1e-6 of the largest value, NaN where the plain loop has
# NaN: the plain loop samples through torch.matmul, whose sums round in
# the library's own way, and the kernel rounds each operation on its own
# (--fmad=false). The backward to rtol 1e-3, atol 1e-5 of the largest
# component: its atomics reorder the sums.
SWEEP_RTOL, SWEEP_ATOL_REL = 1e-4, 1e-6
SWEEP_GRAD_RTOL, SWEEP_GRAD_ATOL_REL = 1e-3, 1e-5
SWEEP_TURNS = ("torch", "cuda", "cuda", "torch")
RECORDS["sweep grad"] = {"sweep_planes_kernel": 1,
                         "sweep_scan_grad_kernel": 1,
                         "sweep_fold_kernel": 1}
# Transfer functions of any size: the forward and the backward are timed
# at these point counts at the default frame (and at the scene's own 4),
# each held against its plain version; the 64-point one also goes through
# a gradient.
TF_POINTS = (17, 64, 256)
# Float operations of the fold a gradient-plane texel and channel: its two
# weights' products and sums.
FOLD_OPS_PER_TEXEL_CHANNEL = 4
# Float operations of the plane pre-pass: a lerped texel 3 a channel; a
# column or row about 35 (its coordinate 3, two hat rows of 14, the mask).
PREP_OPS_PER_TEXEL_CHANNEL = 3
PREP_OPS_PER_RAY_LINE = 35
# tests/test_torch_grad.py's sweep loss at its scene: a 16^3 smoke cloud
# (seed 5), an 8^3 light volume and a weight of the 12^2 image, seeded.
SMALL_TF = (np.array([0.0, 0.25, 0.6, 1.0], np.float32),
            np.array([[0.1, 0.2, 0.3, 0.05], [0.4, 0.5, 0.3, 0.3],
                      [0.9, 0.7, 0.5, 0.6], [1.0, 1.0, 1.0, 0.9]],
                     np.float32))


@contextlib.contextmanager
def swept_by(method: str):
    """Every sweep render of the pipeline through ``method`` while inside:
    the plain loop ("torch"), timed beside the kernels'."""
    saved = sweep_render.sweep_render
    sweep_render.sweep_render = functools.partial(saved, method=method)
    try:
        yield
    finally:
        sweep_render.sweep_render = saved


def sweep_bound(vol_p, light_p, n_v: int, n_u: int, n_planes: int,
                tf_points: int, backward: bool = False) -> dict:
    """The least time of one scan on the card, the larger of: the bytes it
    must move (the volume and the light volume, the rays' coordinates and
    path lengths, 48 B of constants a plane, the transfer function and the
    (V, U, 4) image; the backward also reads the image and its cotangent
    and writes the volumes' and the transfer function's gradients) at
    HBM_BYTES_PER_S, and its operations (every ray at every plane: the
    scan has no early exit; ``sweep_scan.ops_per_sample`` each) at
    FP32_FLOP_PER_S."""
    rays = n_v * n_u
    vols = (vol_p.numel() + light_p.numel()) * 4
    nbytes = (vols + 4 * (n_u + n_v + rays) + 48 * n_planes
              + 20 * tf_points + 16 * rays)
    if backward:
        nbytes += 16 * rays + vols + 20 * tf_points
    ops = rays * n_planes * ss.ops_per_sample(tf_points, backward)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "operations": ops, "samples": rays * n_planes,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def prepass_bound(vol_p, light_p, c, n_u: int, n_v: int,
                  backward: bool = False) -> dict:
    """The least time of the plane pre-pass of one scan, the larger of: the
    bytes it must move (the slabs its planes lerp and the rays'
    coordinates read once, 48 B of constants a plane, its prepared planes
    written once, ``sweep_scan.plane_bytes`` each, and in a ``backward``
    the gradient planes it zeroes, 4 B a texel of the volume's and 12 B a
    texel of the light's, whose pad nothing reads) at HBM_BYTES_PER_S, and
    its operations (PREP_OPS_PER_TEXEL_CHANNEL a lerped texel and channel,
    PREP_OPS_PER_RAY_LINE a column or row) at FP32_FLOP_PER_S."""
    nc, nb = vol_p.shape[1:]
    nc2, nb2 = light_p.shape[1:3]
    planes = c.fz.shape[0]
    slabs = int(torch.unique(torch.cat([c.k0, c.k1])).numel())
    lslabs = int(torch.unique(torch.cat([c.lk0, c.lk1])).numel())
    written = planes * (ss.plane_bytes(nc, nb, nc2, nb2, n_u, n_v)
                        + (4 * nc * nb + 12 * nc2 * nb2 if backward else 0))
    nbytes = (4 * (slabs * nc * nb + lslabs * nc2 * nb2 * 3 + n_u + n_v)
              + 48 * planes + written)
    ops = planes * (PREP_OPS_PER_TEXEL_CHANNEL * (nc * nb + 3 * nc2 * nb2)
                    + PREP_OPS_PER_RAY_LINE * (n_u + n_v))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "operations": ops, "prepared_bytes": written,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fold_bound(vol_p, light_p, c, plan) -> dict:
    """The least time of the folds of one scan's gradient planes, one a
    chunk of ``plan`` ([lo, hi) planes), the larger of: the bytes they must
    move (the gradient planes read once, 4 B a texel of the volume's and
    12 B a texel of the light's, and 20 B of constants a plane; each
    chunk's slabs of the gradients that its planes' lerps touch written
    once, and read where an earlier chunk touched them too) at
    HBM_BYTES_PER_S, and their operations (FOLD_OPS_PER_TEXEL_CHANNEL a
    gradient-plane texel and channel) at FP32_FLOP_PER_S."""
    nc, nb = vol_p.shape[1:]
    nc2, nb2 = light_p.shape[1:3]
    planes = c.fz.shape[0]
    nbytes = planes * (4 * nc * nb + 12 * nc2 * nb2 + 2 * 20)
    for ks, ks2, per in ((c.k0, c.k1, 4 * nc * nb),
                         (c.lk0, c.lk1, 12 * nc2 * nb2)):
        seen = set()
        for lo, hi in plan:
            touched = set(torch.cat([ks[lo:hi], ks2[lo:hi]]).tolist())
            nbytes += per * (len(touched) + len(touched & seen))
            seen |= touched
    ops = planes * FOLD_OPS_PER_TEXEL_CHANNEL * (nc * nb + 3 * nc2 * nb2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_planes(what: str, vol_p, light_p, tf, c, u, v, amb,
                 got_out) -> dict:
    """The planes that the forward's pre-pass left in its scratch against
    their plain version, bit for bit (NaN equal), and the chunks the
    forward made of them; that forward's image is ``got_out``'s (the same
    scan through the render path) bit for bit."""
    u = u.contiguous()
    out, scratch = ss._forward(vol_p, light_p, tf.positions.contiguous(),
                               tf.colors.contiguous(), c, u, v, amb)
    got, (lo, hi) = ss._filled(scratch)
    want = ss._prepare_planes_torch(vol_p, light_p, c, u, v, lo, hi)
    same = all(bool(torch.equal(g.nan_to_num(), w.nan_to_num())
                    and torch.equal(torch.isnan(g), torch.isnan(w)))
               for g, w in zip(got, want))
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        fin = torch.isfinite(g) & torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, float((g - w)[fin].abs().max()))
    per = ss.plane_bytes(*vol_p.shape[1:], *light_p.shape[1:3], u.shape[0],
                         v.shape[0])
    chunks = len(ss.chunk_plan(c.fz.shape[0], per, ss.PLANE_BUDGET))
    image_same = bool(_same_bits(out.reshape(-1), got_out.reshape(-1)).all())
    print(f"plane pre-pass vs its plain version, {what}: planes {lo}-{hi} "
          f"of the forward's scratch equal bit for bit {same} (max_abs_err "
          f"{err:.3e}); {c.fz.shape[0]} planes of {per} B, {chunks} "
          f"chunk(s) under {ss.PLANE_BUDGET} B; its image the render's bit "
          f"for bit {image_same}")
    if not same:
        raise AssertionError(f"{what}: the plane pre-pass differs from its "
                             "plain version")
    if not image_same:
        raise AssertionError(f"{what}: the forward gave another image than "
                             "the render path's")
    return {"bit_equal": same, "max_abs_err": err, "plane_bytes": per,
            "chunks": chunks, "planes_checked": [lo, hi]}


def sweep_close(got, want, what: str, rtol: float = SWEEP_RTOL,
                atol_rel: float = SWEEP_ATOL_REL) -> dict:
    """Assert a kernel's result within rtol and atol_rel x the largest
    finite |plain| of the plain version's, NaN where it has NaN; prints
    and returns the error and each form's NaN count."""
    finite = torch.isfinite(want)
    scale = float(want[finite].abs().max()) if bool(finite.any()) else 0.0
    both = finite & torch.isfinite(got)
    err = float((got - want)[both].abs().max()) if bool(both.any()) else 0.0
    nans = (int(torch.isnan(got).sum()), int(torch.isnan(want).sum()))
    print(f"{what}: max_abs_err {err:.3e} (max |plain| {scale:.3e}; held to "
          f"rtol {rtol:g}, atol {atol_rel:g} of that); NaN kernel / plain "
          f"{nans[0]} / {nans[1]}")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_rel * scale,
                               equal_nan=True,
                               msg=lambda m: f"{what}: {m}")
    return {"max_abs_err": err, "max_abs_plain": scale,
            "nan_kernel": nans[0], "nan_plain": nans[1]}


def check_sweep(what: str, volume, tf, light_volume, camera, rc, tag, *,
                timed: bool = False, columns: slice | None = None) -> dict:
    """The forward kernel against the plain loop on one render's scans,
    one launch per sweep (``columns``: on that slice of the base grid's
    columns, as a rank scans them, and equal bit for bit to the whole
    scan's columns), and on the image where the whole render is scanned
    (``sweep_render`` by each method, whose NaN pixels it counts). With
    ``timed``: the forward's device time (``torch.profiler``), the plane
    pre-pass's and the march's apart, the call's and the plain loop's
    (CUDA events) and the bounds, per render. Each scan's forward is also
    run alone, its planes held against their plain version
    (check_planes)."""
    axis, vol_p, light_p, scans = sweep_render.sweep_plan(
        volume, light_volume, camera, rc)
    amb = rc.ambient

    def scan(method, sched, u, v):
        return sweep_render._scan_planes(vol_p, light_p, tf, sched, u, v,
                                         amb, method)

    res = {"sweeps": len(scans), "rays": [], "planes": [], "prepass": [],
           "tf_points": tf.positions.shape[0]}
    parts = []
    for i, (sched, u, v) in enumerate(scans):
        whole = None
        if columns is not None:
            whole = scan("cuda", sched, u, v)[:, columns]
            u = u[columns]
        parts.append((sched, u, v))
        before = (SWEEP_PREP.launches, SWEEP_FWD.launches)
        got = scan("cuda", sched, u, v)
        torch.cuda.synchronize()
        made = (SWEEP_PREP.launches - before[0],
                SWEEP_FWD.launches - before[1])
        if made != (1, 1):
            raise AssertionError(f"{what}: {made} pre-pass and march "
                                 "launches for one scan")
        want = scan("torch", sched, u, v)
        res[f"sweep {i}"] = sweep_close(
            got, want, f"sweep kernel vs plain loop, {what}, sweep {i} "
            f"({v.shape[0]}x{u.shape[0]} rays x {sched.za.shape[0]} planes)")
        res["prepass"].append(check_planes(
            f"{what}, sweep {i}", vol_p, light_p, tf,
            sweep_render.scan_constants(vol_p, light_p, sched, u, v), u, v,
            amb, got))
        res["rays"].append(v.shape[0] * u.shape[0])
        res["planes"].append(sched.za.shape[0])
        if whole is not None:
            same = bool(_same_bits(got.reshape(-1), whole.reshape(-1)).all())
            print(f"{what}, sweep {i}: the slice's scan equals the whole "
                  f"scan's columns bit for bit: {same}")
            if not same:
                raise AssertionError(f"{what}: a column slice scans other "
                                     "values than the whole scan")
    res["max_abs_err"] = max(res[f"sweep {i}"]["max_abs_err"]
                             for i in range(len(scans)))
    if columns is None:
        before = (SWEEP_PREP.launches, SWEEP_FWD.launches)
        img = sweep_render.sweep_render(volume, tf, light_volume, camera, rc,
                                        method="cuda")
        torch.cuda.synchronize()
        res["launches"] = SWEEP_FWD.launches - before[1]
        if (SWEEP_PREP.launches - before[0], res["launches"]) != (
                len(scans), len(scans)):
            raise AssertionError(f"{what}: {res['launches']} forward "
                                 f"launches for {len(scans)} sweeps")
        want = sweep_render.sweep_render(volume, tf, light_volume, camera,
                                         rc, method="torch")
        res["image"] = sweep_close(
            img, want, f"sweep_render kernel vs plain loop, {what}, image "
            f"{tuple(img.shape)}")
        res["nan_pixels"] = {m: int(torch.isnan(im[..., :3]).any(-1).sum())
                             for m, im in (("cuda", img), ("torch", want))}
    if not timed:
        return res
    n = len(parts)
    key = f"sweep x{n}"
    RECORDS[key] = {"sweep_planes_kernel": n, "sweep_scan_kernel": n}

    def render(method):
        return [scan(method, *p) for p in parts]

    per = device_ms(key, lambda: render("cuda"), reps=5, by_name=True)
    prep_ms, march_ms = per["sweep_planes_kernel"], per["sweep_scan_kernel"]
    dev_ms = prep_ms + march_ms
    if min(prep_ms, march_ms) == 0.0:
        raise AssertionError("torch.profiler showed no device time")
    call = cuda_ms(lambda: render("cuda"), reps=5)
    plain = cuda_ms(lambda: render("torch"), reps=1, warmup=0)
    consts = [sweep_render.scan_constants(vol_p, light_p, *p) for p in parts]
    prep_plain = cuda_ms(lambda: [ss._prepare_planes_torch(
        vol_p, light_p, c, u, v, 0, c.fz.shape[0])
        for c, (_, u, v) in zip(consts, parts)], reps=3)

    def total(bounds):
        out = {k: sum(b[k] for b in bounds) for k in bounds[0]
               if k != "bound_by"}
        return {**out, "bound_by": bounds[0]["bound_by"]}

    bound = total([sweep_bound(vol_p, light_p, v.shape[0], u.shape[0],
                               sched.za.shape[0], tf.positions.shape[0])
                   for sched, u, v in parts])
    prep = total([prepass_bound(vol_p, light_p, c, u.shape[0], v.shape[0])
                  for c, (_, u, v) in zip(consts, parts)])
    print(f"sweep {what}: forward device time {dev_ms:.4f} ms (pre-pass "
          f"{prep_ms:.4f}, march {march_ms:.4f}) at "
          f"{tf.positions.shape[0]} TF points; call {call:.3f} ms, plain loop {plain:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['samples']} samples, {bound['bytes']} B), "
          f"{bound['bound_ms'] / dev_ms:.1%} of it; pre-pass bound "
          f"{prep['bound_ms']:.4f} ms ({prep['bound_by']}: "
          f"{prep['bytes']} B, {prep['prepared_bytes']} B prepared in "
          f"{sum(r['chunks'] for r in res['prepass'])} chunk(s)), "
          f"{prep['bound_ms'] / prep_ms:.1%} of it, its plain version "
          f"{prep_plain:.3f} ms ({tag})")
    res.update({"ms": dev_ms, "prepass_ms": prep_ms, "march_ms": march_ms,
                "call_ms": call, "plain_ms": plain, **bound,
                "share_of_bound": bound["bound_ms"] / dev_ms,
                "prepass_timed": {"ms": prep_ms, "plain_ms": prep_plain,
                                  **prep, "share_of_bound":
                                  prep["bound_ms"] / prep_ms}})
    return res


def sweep_grads(volume, tf, light_volume, camera, rc, weight,
                method: str) -> tuple:
    """Gradients of sum(image x ``weight``) (float64 sum) through
    ``sweep_render`` by ``method``, with respect to the volume data, the
    light volume and the TF's positions and colours."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        volume.data, light_volume, tf.positions, tf.colors)]
    img = sweep_render.sweep_render(
        dataclasses.replace(volume, data=leaves[0]),
        TransferFunction(positions=leaves[2], colors=leaves[3], lut=tf.lut),
        leaves[1], camera, rc, method=method)
    return torch.autograd.grad((img.double() * weight).sum(), leaves)


GRAD_NAMES = ("volume", "light volume", "tf positions", "tf colours")


class PlainScan(torch.autograd.Function):
    """The plain loop with the backward's plain version
    (``_scan_planes_grad_torch``) as its gradient: the plain form of
    ``kernels/sweep_scan.SweepScan``. Autograd through the plain loop keeps
    every operator's inputs (a 64-point TF at the default frame would hold
    hundreds of GB); this keeps none."""

    @staticmethod
    def forward(ctx, vol_p, light_p, pos, cols, c, u, v, ambient):
        tf = TransferFunction(positions=pos, colors=cols, lut=None)
        out = sweep_render._scan_planes_torch(vol_p, light_p, tf, c, u, v,
                                              ambient)
        ctx.save_for_backward(vol_p, light_p, pos, cols, u, v, out)
        ctx.c, ctx.ambient = c, ambient
        return out

    @staticmethod
    def backward(ctx, grad_out):
        vol_p, light_p, pos, cols, u, v, out = ctx.saved_tensors
        tf = TransferFunction(positions=pos, colors=cols, lut=None)
        grads = sweep_render._scan_planes_grad_torch(
            vol_p, light_p, tf, ctx.c, u, v, ctx.ambient, out,
            grad_out.contiguous())
        return (*grads, None, None, None, None)


@contextlib.contextmanager
def scanned_plainly():
    """Every plane scan through PlainScan while inside."""
    saved = sweep_render._scan_planes

    def plain(vol_p, light_p, tf, sched, u, v, ambient, method="auto"):
        c = sweep_render.scan_constants(vol_p, light_p, sched, u, v)
        return PlainScan.apply(vol_p, light_p, tf.positions, tf.colors, c, u,
                               v, ambient)

    sweep_render._scan_planes = plain
    try:
        yield
    finally:
        sweep_render._scan_planes = saved


def check_sweep_grad(what: str, volume, tf, light_volume, camera, rc,
                     weight, tag, *, timed: bool = False,
                     plain_backward: bool = False) -> dict:
    """The backward kernels (through ``SweepScan``) against autograd through
    the plain loop (``plain_backward``: through PlainScan, the plain loop
    with the backward's plain version), for the loss sum(image x
    ``weight``): each gradient within SWEEP_GRAD_RTOL, SWEEP_GRAD_ATOL_REL
    x its largest component; the gradient of one sweep launches the
    forward's pre-pass and march and the backward's pre-pass, gradient
    march and fold once each. With ``timed``: the kernels alone
    (time_sweep_grad) and both whole gradients timed."""
    args = (volume, tf, light_volume, camera, rc, weight)
    before = read_counts()
    got = sweep_grads(*args, "cuda")
    torch.cuda.synchronize()
    made = {k: n - before[k] for k, n in read_counts().items()
            if k.startswith("sweep_")}
    with scanned_plainly() if plain_backward else contextlib.nullcontext():
        want = sweep_grads(*args, "torch")
    after = {k: n - before[k] for k, n in read_counts().items()
             if k.startswith("sweep_")}
    if after != made or made != {"sweep_planes": 2, "sweep_scan_forward": 1,
                                 "sweep_scan_backward": 1, "sweep_fold": 1}:
        raise AssertionError(f"{what}: sweep launches {made} for one "
                             f"gradient, {after} with the plain one")
    against = ("the plain loop with its plain backward" if plain_backward
               else "autograd through the plain loop")
    res = {name: sweep_close(g, w, f"sweep backward (SweepScan) vs "
                             f"{against}, {what}: {name}",
                             SWEEP_GRAD_RTOL, SWEEP_GRAD_ATOL_REL)
           for name, g, w in zip(GRAD_NAMES, got, want)}
    res["max_abs_err"] = max(res[n]["max_abs_err"] for n in GRAD_NAMES)
    res["launches"] = made
    if not timed:
        return res
    res.update(time_sweep_grad(what, volume, tf, light_volume, camera, rc,
                               weight, tag, time_plain=True))
    whole = {m: cuda_ms(lambda m=m: sweep_grads(*args, m), reps=1)
             for m in ("cuda", "torch")}
    print(f"sweep gradient, {what}: the whole gradient (render and "
          f"backward) through the kernels {whole['cuda']:.3f} ms, through "
          f"autograd of the plain loop {whole['torch']:.3f} ms ({tag})")
    res["whole_gradient_ms"] = whole
    return res


def _cpu_constants(c):
    """A scan's constants on the CPU."""
    return c._replace(**{f: t.cpu() for f, t in c._asdict().items()
                         if isinstance(t, torch.Tensor)})


def _tf_piece(tf, x):
    """The piece of the transfer function's subgradient at each sample
    ``x``, as ``sweep_render._tf_sample_grad`` takes it: (the segment, the
    last point at or below x, -1 for none; whether its parameter t sits on
    0 or 1, where the clip halves the gradient)."""
    pos = tf.positions
    seg = torch.searchsorted(pos[:-1].contiguous(), x, right=True) - 1
    s = seg.clamp(min=0)
    t_raw = (x - pos[s]) / torch.clamp(pos[s + 1] - pos[s], min=1e-12)
    return seg, (seg >= 0) & ((t_raw == 0.0) | (t_raw == 1.0))


def tf_kinks(vol_p, tf, c, u, v, planes) -> dict:
    """The samples of a scan at which the transfer function's subgradient
    takes another piece under the kernels' sampling (the taps of
    ``planes``, every plane prepared) than under the plain loop's
    (hat-matrix products): another
    segment, or t on 0 or 1 (half the slope) in one form only. Such a
    sample's dL/dx differs, and that goes to the volume's texels under its
    taps and to the points of its segments; its value, so its colour and
    opacity, agrees to rounding, so the light volume's and the colours'
    gradients do not move. Returns {"samples": the count, "volume": bool
    like vol_p, "tf positions": bool (P,)}."""
    nc, nb = vol_p.shape[1:]
    n_points = tf.positions.shape[0]
    kinks = 0
    vol = torch.zeros(vol_p.shape, dtype=torch.bool, device=vol_p.device)
    pos = torch.zeros(n_points, dtype=torch.bool, device=vol_p.device)
    for k in range(c.fz.shape[0]):
        taps = sweep_render._fetch_plane_torch(planes, k)[0]
        b_k = c.o_b + c.w_planes[k] * (u - c.o_b)
        c_k = c.o_c + c.w_planes[k] * (v - c.o_c)
        r_b = sweep_render._hat_matrix(b_k, nb)
        r_c = sweep_render._hat_matrix(c_k, nc)
        prod = (r_c @ planes.vol[k]) @ r_b.T
        (seg_k, tie_k), (seg_p, tie_p) = _tf_piece(tf, taps), \
            _tf_piece(tf, prod)
        kinked = (seg_k != seg_p) | (tie_k != tie_p)
        if not bool(kinked.any()):
            continue
        kinks += int(kinked.sum())
        under = (r_c.double().T @ kinked.double() @ r_b.double()) > 0.0
        for slab, w in ((c.k0[k], 1.0 - c.fz[k]), (c.k1[k], c.fz[k])):
            if float(w) != 0.0:
                vol[slab] |= under
        ends = torch.cat([seg_k[kinked], seg_p[kinked]])
        pos[torch.cat([ends, ends + 1]).clamp(0, n_points - 1)] = True
    return {"samples": kinks, "volume": vol, "tf positions": pos}


def held_off_kinks(got, want, under, what: str, kinks: int,
                   held: bool = True) -> dict:
    """Assert a backward's gradient within SWEEP_GRAD_RTOL and
    SWEEP_GRAD_ATOL_REL x the plain version's largest |component| at every
    element outside ``under`` (the elements that the samples of
    ``tf_kinks`` reach, None for none), NaN where it has NaN; prints and
    returns the error there and the elements under them that lie outside
    the tolerance. Not ``held``: printed only."""
    finite = torch.isfinite(want)
    scale = float(want[finite].abs().max()) if bool(finite.any()) else 0.0
    close = torch.isclose(got, want, rtol=SWEEP_GRAD_RTOL,
                          atol=SWEEP_GRAD_ATOL_REL * scale, equal_nan=True)
    under = torch.zeros_like(close) if under is None else under
    both = finite & torch.isfinite(got)
    diff = (got - want).abs()
    err = float(diff[both & ~under].max()) if bool((both & ~under).any()) \
        else 0.0
    res = {"max_abs_err": err, "max_abs_plain": scale,
           "under_kinks": int(under.sum()),
           "outside_under_kinks": int((~close & under).sum()),
           "outside_elsewhere": int((~close & ~under).sum())}
    print(f"{what}: max_abs_err {err:.3e} away from the {kinks} samples at "
          f"another piece of the TF's subgradient (max |plain| {scale:.3e}; "
          f"tolerance rtol {SWEEP_GRAD_RTOL:g}, atol {SWEEP_GRAD_ATOL_REL:g} "
          f"of that); {res['outside_under_kinks']} of the "
          f"{res['under_kinks']} elements those samples reach lie outside "
          f"it, {res['outside_elsewhere']} of the rest"
          + ("" if held else " (printed: a sample adds g (x - p) / w^2 to "
             "its points', so its rounding of x counts g / w^2 times, w its "
             "segment's width)"))
    if held and res["outside_elsewhere"]:
        raise AssertionError(f"{what}: {res['outside_elsewhere']} elements "
                             "that no sample at another piece of the TF's "
                             "subgradient reaches lie outside the tolerance")
    return res


def time_sweep_grad(what: str, volume, tf, light_volume, camera, rc, weight,
                    tag, time_plain: bool = False) -> dict:
    """The backward kernels alone on the render's first sweep, for the
    image's own cotangent of the intermediate: all four gradients within
    the backward's tolerance of the plain version that runs as the kernels
    do (``_scan_planes_grad_chunked_torch``: the prepared planes, the
    kernels' taps, their row scatter and fold) and of the plain loop on
    the kernels' samples (``_scan_planes_grad_torch`` with the prepared
    planes: one pass, the hat matrices' scatter); and of the plain loop
    itself (samples from hat-matrix products): with ``time_plain`` every
    element, else every element of the volume's, the light volume's and
    the colours' gradients that no sample of ``tf_kinks`` reaches (where a
    sample lies on a TF point, a last bit picks the segment whose slope its
    gradient takes, or whether the clip halves it), the positions' printed
    (a sample adds g (x - p) / w^2 to them, so its rounding of x counts
    g / w^2 times, w its segment's width); the fold's gradients of the
    volume and the light volume bit for bit its plain version's
    (``_fold_plane_grads_torch``, on the CPU) on the gradient march's own
    planes (every driven sweep is one chunk); the device time of the
    pre-pass, the gradient march and the fold (``torch.profiler``) apart
    and together, each beside its bound; the call's time, and with
    ``time_plain`` the plain versions'."""
    axis, vol_p, light_p, scans = sweep_render.sweep_plan(
        volume, light_volume, camera, rc)
    sched, u, v = scans[0]
    u = u.contiguous()
    amb = rc.ambient
    c = sweep_render.scan_constants(vol_p, light_p, sched, u, v)
    inter = sweep_render._scan_planes(vol_p, light_p, tf, sched, u, v, amb,
                                      "cuda").requires_grad_(True)
    img = sweep_render._warp(inter, sched, axis, rc.width, rc.height)
    g_inter, = torch.autograd.grad((img.double() * weight).sum(), inter)
    inter = inter.detach()
    pos, cols = tf.positions.contiguous(), tf.colors.contiguous()
    kargs = (vol_p, light_p, pos, cols, c, u, v, amb, inter, g_inter)
    points = pos.shape[0]

    def kernel():
        return ss.sweep_scan_backward(*kargs)

    def plain():
        return sweep_render._scan_planes_grad_torch(
            vol_p, light_p, tf, c, u, v, amb, inter, g_inter)

    grads, scratch = ss._backward(*kargs)
    bare = {name: sweep_close(g, w, f"backward kernels vs "
                              f"_scan_planes_grad_chunked_torch, {what}, "
                              f"{points} TF points: {name}", SWEEP_GRAD_RTOL,
                              SWEEP_GRAD_ATOL_REL)
            for name, g, w in zip(GRAD_NAMES, grads,
                                  sweep_render._scan_planes_grad_chunked_torch(
                                      vol_p, light_p, tf, c, u, v, amb, inter,
                                      g_inter))}
    prepared = ss._prepare_planes_torch(vol_p, light_p, c, u, v, 0,
                                        c.fz.shape[0])
    by_taps = {name: sweep_close(g, w, f"backward kernels vs "
                                 f"_scan_planes_grad_torch on the kernels' "
                                 f"samples, {what}, {points} TF points: "
                                 f"{name}", SWEEP_GRAD_RTOL,
                                 SWEEP_GRAD_ATOL_REL)
               for name, g, w in zip(GRAD_NAMES, grads,
                                     sweep_render._scan_planes_grad_torch(
                                         vol_p, light_p, tf, c, u, v, amb,
                                         inter, g_inter, planes=prepared))}
    kinked = None if time_plain else tf_kinks(vol_p, tf, c, u, v, prepared)
    by_products = {} if time_plain else {"kinked_samples": kinked["samples"]}
    for name, g, w in zip(GRAD_NAMES, grads, plain()):
        against = (f"backward kernels vs _scan_planes_grad_torch, {what}, "
                   f"{points} TF points: {name}")
        by_products[name] = sweep_close(
            g, w, against, SWEEP_GRAD_RTOL, SWEEP_GRAD_ATOL_REL) \
            if time_plain else held_off_kinks(
                g, w, kinked.get(name), against, kinked["samples"],
                held=name != "tf positions")
    del prepared
    g_p_vol, g_p_light, (lo, hi) = ss._grad_planes(scratch)
    if (lo, hi) != (0, c.fz.shape[0]):
        raise AssertionError(f"{what}: the backward took more than one "
                             "chunk")
    folded = sweep_render._fold_plane_grads_torch(
        torch.zeros_like(vol_p, device="cpu"),
        torch.zeros_like(light_p, device="cpu"), g_p_vol.cpu(),
        g_p_light.cpu(), _cpu_constants(c), lo, hi)
    fold_same = all(bool(torch.equal(g.cpu(), w))
                    for g, w in zip(grads[:2], folded))
    fold_err = max(float((g.cpu().double() - w.double()).abs().max())
                   for g, w in zip(grads[:2], folded))
    print(f"fold kernel vs _fold_plane_grads_torch on the gradient march's "
          f"own planes {lo}-{hi}, {what}, {points} TF points: the volume's "
          f"and the light volume's gradients equal bit for bit {fold_same} "
          f"(max_abs_err {fold_err:.3e})")
    if not fold_same:
        raise AssertionError(f"{what}: the fold kernel differs from its "
                             "plain version")
    del grads, scratch

    per = device_ms("sweep grad", kernel, reps=5, by_name=True)
    prep_ms = per["sweep_planes_kernel"]
    march_ms = per["sweep_scan_grad_kernel"]
    fold_ms = per["sweep_fold_kernel"]
    dev_ms = prep_ms + march_ms + fold_ms
    if min(prep_ms, march_ms, fold_ms) == 0.0:
        raise AssertionError("torch.profiler showed no device time")
    call = cuda_ms(kernel, reps=5)
    bound = sweep_bound(vol_p, light_p, v.shape[0], u.shape[0],
                        sched.za.shape[0], points, backward=True)
    prep = prepass_bound(vol_p, light_p, c, u.shape[0], v.shape[0],
                         backward=True)
    fold = fold_bound(vol_p, light_p, c, [(lo, hi)])
    plains = {}
    if time_plain:
        plains["plain_ms"] = cuda_ms(plain, reps=1, warmup=0)
        g_p_vol, g_p_light = g_p_vol.clone(), g_p_light.clone()
        plains["fold_plain_ms"] = cuda_ms(
            lambda: sweep_render._fold_plane_grads_torch(
                torch.zeros_like(vol_p), torch.zeros_like(light_p), g_p_vol,
                g_p_light, c, lo, hi), reps=3)
    print(f"sweep backward, {what}, {points} TF points: device time "
          f"{dev_ms:.4f} ms (pre-pass {prep_ms:.4f}, gradient march "
          f"{march_ms:.4f}, fold {fold_ms:.4f}), call {call:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['samples']} samples, {bound['bytes']} B), "
          f"{bound['bound_ms'] / dev_ms:.1%} of it; pre-pass bound "
          f"{prep['bound_ms']:.4f} ms ({prep['bound_by']}), "
          f"{prep['bound_ms'] / prep_ms:.1%}; fold bound "
          f"{fold['bound_ms']:.4f} ms ({fold['bound_by']}: {fold['bytes']} "
          f"B), {fold['bound_ms'] / fold_ms:.1%}"
          + "".join(f"; {k} {t:.3f}" for k, t in plains.items())
          + f" ({tag})")
    return {"bare_vs_plain": bare, "bare_vs_taps": by_taps,
            "bare_vs_products": by_products,
            "tf_points": points, "ms": dev_ms,
            "prepass_ms": prep_ms, "march_ms": march_ms, "fold_ms": fold_ms,
            "call_ms": call, **plains, **bound,
            "share_of_bound": bound["bound_ms"] / dev_ms,
            "bare_max_abs_err": max(r["max_abs_err"] for r in bare.values()),
            "prepass_bound": {**prep, "share_of_bound":
                              prep["bound_ms"] / prep_ms},
            "fold": {"ms": fold_ms, "max_abs_err": fold_err,
                     "bit_equal": fold_same, **fold,
                     "share_of_bound": fold["bound_ms"] / fold_ms}}


def small_grad_scene(dev):
    """tests/test_torch_grad.py's sweep loss on ``dev``: (volume, TF, light
    volume, camera, render config, weight)."""
    volume = Volume.from_data(synthetic.smoke_cloud(16, seed=5), device=dev)
    tf = TransferFunction.from_points(*SMALL_TF, device=dev)
    lv = torch.from_numpy(np.random.default_rng(2).uniform(
        0.0, 2.0, (8, 8, 8, 3)).astype(np.float32)).to(dev)
    w = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.5, (12, 12, 4))).to(dev)
    return (volume, tf, lv, Camera.create(eye=(0.45, 0.6, -1.5), device=dev),
            RenderConfig(width=12, height=12, sampling_rate=1.5), w)


def many_point_tf(tf, n: int, seed: int = 12):
    """A transfer function of ``n`` points as a TF editor makes them: seeded
    sorted positions over ``tf``'s range, ``tf``'s colours there, each
    channel moved by a seeded factor in [0.8, 1.2] and clipped to [0, 1]."""
    lo, hi = (float(x) for x in tf.positions[[0, -1]])
    rs = np.random.default_rng(seed)
    pos = np.sort(rs.uniform(lo, hi, n)).astype(np.float32)
    pos[0], pos[-1] = lo, hi
    cols = tf.sample(torch.from_numpy(pos).to(tf.positions.device))
    cols = np.clip(cols.cpu().numpy() * rs.uniform(0.8, 1.2, (n, 4)), 0.0,
                   1.0).astype(np.float32)
    return TransferFunction.from_points(pos, cols, device=tf.positions.device)


def sweep_sass(tag) -> dict:
    """Each sweep kernel's registers and the static instructions of its
    plane loop (``scripts/sass_counts.py`` on the built library), where the
    toolkit has ``cuobjdump``; the registers are also in the build's
    ``-Xptxas -v`` report."""
    spec = importlib.util.spec_from_file_location(
        "sass_counts", Path(__file__).resolve().parent / "scripts"
        / "sass_counts.py")
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    if not os.path.exists(sass.cuobjdump()):
        print(f"SASS of the sweep kernels: not measured, no cuobjdump beside "
              f"nvcc ({tag})")
        return {}
    counts = sass.report(ss.build()[0], sass.kernel_names(ss.SOURCE))
    for name, c in counts.items():
        print(f"SASS of {name}: {c['registers']} registers, {c['loop']} "
              f"instructions in its main loop (loops inside it: "
              f"{c['inner']}), {c['instructions']} in all ({tag})")
    return counts


def sweep_kernel_phase(scene, config, state, dev, tag) -> dict:
    """The sweep kernels at the default frame: their registers and static
    instructions; the forward against the plain loop on the frame, the
    eye-inside camera (two sweeps), a rank's half of the columns and a
    strided fifth of them, timed beside the bound on the frame and the eye
    inside (the plane pre-pass and the march apart); the frame with TFs
    of 17, 64 and 256 points, timed; ``entry``'s forward, counted; the backward against
    autograd through the plain loop on the frame's image loss (timed, and
    the kernels alone against their plain versions) and on
    tests/test_torch_grad.py's sweep loss, and against the plain loop with
    its plain backward with the 64-point TF; the backward's kernels alone
    at 17, 64 and 256 TF points, timed; then render_state, the frame
    and a packed interactive frame in turns through the kernels and the
    plain loop, and the host waits of one render in each form."""
    t0 = time.perf_counter()
    rc, lv = config.render, state.light_volume_accum
    vol, tf, camera = scene.volume, scene.tf, scene.camera
    res = {"sass": sweep_sass(tag)}
    res["default frame"] = check_sweep(
        "default frame", vol, tf, lv, camera, rc, tag, timed=True)
    inside = Camera.create(eye=(0.5, 0.5, 0.45), center=(0.5, 0.5, 2.0))
    res["eye inside"] = check_sweep(
        f"eye inside ({INSIDE_SIDE}^2 at sampling rate 4)", vol, tf, lv,
        inside, RenderConfig(width=INSIDE_SIDE, height=INSIDE_SIDE,
                             sampling_rate=4.0), tag, timed=True)
    n_u = sweep_render._round_up(int(rc.width * rc.inter_scale), 128)
    res["rank 1 of 2"] = check_sweep(
        "rank 1 of 2's columns", vol, tf, lv, camera, rc, tag,
        columns=slice(n_u // 2, n_u))
    res["strided columns"] = check_sweep(
        "every fifth column (a strided slice, a ragged last block)", vol,
        tf, lv, camera, rc, tag, columns=slice(1, None, 5))
    # Transfer functions of any size, timed: the compare loop runs over
    # every point, so the march's time grows with them.
    many = {n: many_point_tf(tf, n) for n in TF_POINTS}
    for n, tf_n in many.items():
        res[f"{n}-point TF"] = check_sweep(
            f"default frame, a {n}-point TF", vol, tf_n, lv, camera, rc, tag,
            timed=True)
    tf64 = many[64]

    # entry.py's forward step, counted.
    forward, (e_scene, e_state) = port_entry.entry()
    reset_counts()
    e_img = forward(e_scene, e_state)
    torch.cuda.synchronize()
    e_launches = read_counts()
    splats = (e_launches["splat_product_direct"]
              + e_launches["splat_product_tiled"])
    print(f"entry.entry's forward (a full trace + splat + sweep, "
          f"{tuple(e_img.shape)}): launches {e_launches} ({tag})")
    if (e_launches["trace_woodcock_cuda"], splats, e_launches[
            "sweep_planes"], e_launches["sweep_scan_forward"]) != (
            1, 1, 1, 1) or not bool(
            torch.isfinite(e_img).all()) or e_img.device != dev:
        raise AssertionError("entry's forward did not run each kernel once "
                             "on the card")

    # The backward.
    weight = torch.tensor((*GRAD_CHANNELS, 0.0), dtype=torch.float64,
                          device=dev)
    res["grad default frame"] = check_sweep_grad(
        "the default frame's image loss", vol, tf, lv, camera, rc, weight,
        tag, timed=True)
    res["grad small"] = check_sweep_grad(
        "tests/test_torch_grad.py's sweep loss", *small_grad_scene(dev), tag)
    res["grad 64-point TF"] = check_sweep_grad(
        "the default frame's image loss, a 64-point TF", vol, tf64, lv,
        camera, rc, weight, tag, plain_backward=True)
    # The backward at many TF points, timed and held against its plain
    # version.
    for n, tf_n in many.items():
        res[f"grad timed {n}-point TF"] = time_sweep_grad(
            "the default frame's image loss", vol, tf_n, lv, camera, rc,
            weight, tag)

    # End to end, the kernels against the plain loop, in turns; the host
    # waits of one render in each form.
    edited = edit_tf(scene)
    grid = step.build_importance_grid(edited, config)
    budget = step.recompute_budget(config, state.light_samples.n)
    packed_state = packed.pack_state(state)
    turns = {}
    for name, fn in (
            ("render_state", lambda: step.render_state(scene, state,
                                                      config)),
            ("frame (full_trace_step + render_state)",
             lambda: run_frame(scene, config)),
            ("interactive_frame", lambda: packed.interactive_frame(
                edited, packed_state, camera, grid, config, budget,
                fresh_round=True))):
        runs = []
        for m in SWEEP_TURNS:
            with swept_by(m):
                runs.append((m, cuda_ms(fn, reps=2)))
        turns[name] = runs
        print(f"{name} in turns: " + ", ".join(
            f"{m} {t:.3f} ms" for m, t in runs) + f" ({tag})")
    waits = {}
    for m in ("torch", "cuda"):
        with swept_by(m):
            waits[m] = dict(host_waits(
                lambda: step.render_state(scene, state, config)))
        print(f"host waits of one render_state, {m}: "
              f"{sum(waits[m].values())} ("
              + ", ".join(f"{w} x{c}" for w, c in waits[m].items())
              + f") ({tag})")
    if sum(waits["cuda"].values()) > sum(waits["torch"].values()):
        raise AssertionError("the sweep kernels add host waits")
    print(f"the sweep kernel phase took {time.perf_counter() - t0:.1f} s")
    return {"lists": res, "entry_launches": e_launches,
            "end_to_end_in_turns": turns, "host_waits": waits}


def sweep_rows(phase: dict, by_path: dict, plane_launches: int,
               grad_launches: int, fold_launches: int, extra: dict) -> list:
    """The ``kernels`` rows of the sweep kernels: the forward's numbers at
    the default frame (its plane pre-pass and march together, and at
    each TF size timed) and its launches on every driven path (the default
    frame's at the top), the pre-pass's own, the backward's on the default
    frame's image loss (its pre-pass, gradient march and fold together, and
    at each TF size timed) and its launches from one
    ``trajectory_gradients``, and the fold's own."""
    lists = {**phase["lists"], **extra}
    d, g = lists["default frame"], lists["grad default frame"]
    sass_counts = lists.pop("sass")
    common = {"route": "cuda", "source": "cpm_tpu_torch/csrc/sweep_scan.cu",
              "replaces": "cpm_tpu/ops/sweep_render.py:203",
              "held_against_plain": True, "library_ms": None,
              "library_note": "no library call computes it"}
    forward = {
        "name": "sweep_scan_forward", **common,
        "replaces_note": "no Pallas kernel: the lax.scan of _scan_planes "
                         "(:203-271) with its hat-matrix products",
        "caller": "render_state (default frame), and every sweep render",
        "launches": by_path["full_trace_step + render_state (default "
                            "frame)"],
        "launches_by_path": by_path,
        "max_abs_err": d["max_abs_err"], "ms": d["ms"],
        "ms_is": "the plane pre-pass and the march together, one chunk",
        "prepass_ms": d["prepass_ms"], "march_ms": d["march_ms"],
        "by_tf_points": {
            r["tf_points"]: {k: r[k] for k in (
                "ms", "prepass_ms", "march_ms", "bound_ms", "share_of_bound",
                "max_abs_err")}
            for r in (d, *(lists[f"{n}-point TF"] for n in TF_POINTS))},
        "call_ms": d["call_ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "share_of_bound": d["share_of_bound"],
        "sass": sass_counts,
        "lists": {k: v for k, v in lists.items()
                  if not k.startswith("grad ")},
        "entry_launches": phase["entry_launches"],
        "end_to_end_in_turns": phase["end_to_end_in_turns"],
        "host_waits_per_render": phase["host_waits"]}
    p = d["prepass_timed"]
    prepass = {
        "name": "sweep_planes", **common,
        "replaces": "cpm_tpu/ops/sweep_render.py:224",
        "replaces_note": "no Pallas kernel: the slab lerps and hat matrices "
                         "of each plane inside the lax.scan of _scan_planes "
                         "(:224-251)",
        "caller": "render_state (default frame), before each chunk's march",
        "launches": plane_launches,
        "max_abs_err": max(r["max_abs_err"] for r in d["prepass"]),
        "max_abs_err_of": "every field against _prepare_planes_torch at the "
                          "default frame, held bit for bit (NaN equal) at "
                          "every checked scan",
        "ms": p["ms"], "plain_ms": p["plain_ms"],
        "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
        "share_of_bound": p["share_of_bound"], "bytes": p["bytes"],
        "prepared_bytes": p["prepared_bytes"],
        "plane_budget_bytes": ss.PLANE_BUDGET,
        "chunks": [r["chunks"] for r in d["prepass"]]}
    timed = [g, *(lists[f"grad timed {n}-point TF"] for n in TF_POINTS)]
    backward = {
        "name": "sweep_scan_backward", **common,
        "replaces_note": "no TPU kernel: the reference differentiates the "
                         "lax.scan of _scan_planes (:203-271) with jax.grad",
        "caller": "score_grad.trajectory_gradients (default frame), and "
                  "every gradient through the sweep",
        "launches": grad_launches,
        "launches_are": "the gradient march's; one pre-pass and one fold "
                        "with each (rows sweep_planes, sweep_fold)",
        "max_abs_err": g["max_abs_err"],
        "max_abs_err_of": "the four gradients of the default frame's image "
                          "loss against autograd through the plain loop",
        "ms": g["ms"],
        "ms_is": "the backward's pre-pass, gradient march and fold "
                 "together, one chunk",
        "prepass_ms": g["prepass_ms"], "march_ms": g["march_ms"],
        "fold_ms": g["fold_ms"],
        "by_tf_points": {r["tf_points"]: {k: r[k] for k in (
            "ms", "prepass_ms", "march_ms", "fold_ms", "bound_ms",
            "share_of_bound", "bare_max_abs_err")} for r in timed},
        "call_ms": g["call_ms"], "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
        "share_of_bound": g["share_of_bound"],
        "lists": {k: v for k, v in lists.items() if k.startswith("grad ")}}
    f = g["fold"]
    fold = {
        "name": "sweep_fold", **common,
        "replaces": "cpm_tpu/ops/sweep_render.py:231",
        "replaces_note": "no TPU kernel: jax.grad's adjoint of the slab "
                         "lerps (:229-239) inside the lax.scan of "
                         "_scan_planes",
        "caller": "score_grad.trajectory_gradients (default frame), after "
                  "each chunk's gradient march",
        "launches": fold_launches,
        "max_abs_err": f["max_abs_err"],
        "max_abs_err_of": "the volume's and the light volume's gradients "
                          "against _fold_plane_grads_torch on the gradient "
                          "march's own planes at the default frame, held "
                          "bit for bit",
        "ms": f["ms"], "plain_ms": g["fold_plain_ms"],
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "share_of_bound": f["share_of_bound"], "bytes": f["bytes"],
        "library_note": "no one library call: the fold is two weighted "
                        "index_add_ calls a volume (its plain version)"}
    return [forward, prepass, backward, fold]



# --- the correlated update ------------------------------------------------


def drain(scene, config, state, grid) -> tuple:
    """A fresh transfer-function invalidation, then progressive ticks until
    no flagged photon remains, all through ``step()``: (the drained state,
    the state after the first batch, the number of batches)."""
    state = first = step.step(scene, state, config, DirtyFlags(tf=True), grid)
    batches = 1
    while state.n_remaining > 0:
        state = step.step(scene, state, config, DirtyFlags(progressive=True),
                          grid)
        batches += 1
        if batches > 4096:
            raise AssertionError("the drain did not converge")
    return state, first, batches


def batch_deposits(before, after, config) -> tuple:
    """The signed delta list (positions, powers) that the correlated step
    from ``before`` to ``after`` handed the splat, rebuilt from the two
    states: while flagged photons remain, ``after.retraced`` marks the
    batch, and a full batch in ascending order is the step's own order."""
    budget = step.recompute_budget(config, before.photons.n)
    indices = torch.nonzero(after.retraced & ~before.retraced)[:, 0]
    if after.n_remaining <= 0 or indices.shape[0] != budget:
        raise AssertionError(
            f"the batch is not a full one: {indices.shape[0]} of {budget} "
            f"lanes, {after.n_remaining} remaining")
    old = dataclasses.replace(
        before.photons, iteration=0,
        radius_rel=f32_scalar(config.tracer.radius_rel))
    return splat.delta_deposits(old, after.photons, indices,
                                torch.ones_like(indices, dtype=torch.bool))


def check_on_list(what: str, pos, pw, r: float, dim, reps: int,
                  tag) -> tuple:
    """Both designs and the plain version on one deposit list: held
    together, then timed in turns beside the bound. Returns (the numbers,
    the plain version's grid)."""
    ref = sp.splat_product_torch(pos, pw, r, dim)
    errs = {}
    for design, fn in DESIGNS.items():
        got = fn(pos, pw, r, dim)
        torch.cuda.synchronize()
        errs[design] = compare(got, ref, f"splat {design} vs plain on {what}")
    res = time_on_list(what, pos, pw, r, dim, reps, tag)
    res["max_abs_err"] = errs
    res["plain_ms"] = cuda_ms(
        lambda: sp.splat_product_torch(pos, pw, r, dim), reps=3)
    print(f"plain splat on {what}: {res['plain_ms']:.3f} ms ({tag})")
    return res, ref


def host_waits(fn) -> collections.Counter:
    """Where ``fn`` makes the host wait for the card (a value read back, or
    a small constant uploaded, which waits for the stream as well), as
    torch's sync debug mode reports it: {"file:line": times}. Empty where
    the mode reports nothing."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def correlated_default(scene, config, state, dev, tag) -> dict:
    """The correlated update at the default frame, from the state a full
    trace left: the counted drain through ``step()`` after a TF edit, the
    drained-equals-full and zero-changes-nothing checks, the first batch's
    delta deposits through both designs and the plain version, and the
    stage times. Returns the numbers for the ``kernels`` line."""
    dim = step.light_volume_shape(config)
    r = f32_scalar(config.tracer.radius_rel)
    n = state.photons.n
    budget = step.recompute_budget(config, n)
    slots = 2 * state.photons.max_interactions * budget
    design = sp.choose_design(slots, r, dim)
    edited = edit_tf(scene)

    # 1. The drain, counted.
    grid = step.build_importance_grid(edited, config)
    imp = step.recompute_importance(config, grid, state.photons,
                                    state.light_samples)
    flagged = int((imp > 0.0).sum())
    want_batches = -(-flagged // budget)
    reset_counts()
    t0 = time.perf_counter()
    drained, first, batches = drain(edited, config, state, grid)
    img = step.render_state(edited, drained, config)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    alpha = float(img[..., 3].max())
    print(f"correlated drain after a TF edit (first run): {flagged} of {n} "
          f"photons flagged, budget {budget}, {batches} batches + render in "
          f"{ms:.1f} ms; {slots} signed delta slots a batch -> {dim}, design "
          f"{design}, launches {launches}; image alpha max {alpha:.4f} "
          f"({tag})")
    if not 0 < flagged or batches != want_batches:
        raise AssertionError(f"the drain took {batches} batches, not "
                             f"ceil({flagged} / {budget}) = {want_batches}")
    expect_launches("correlated drain", launches, [design] * batches,
                    sweeps=1)
    if drained.n_remaining != 0 or bool(drained.retraced.any()):
        raise AssertionError("the drain left flagged photons or its mask")
    if drained.recompute_phase != state.recompute_phase + batches:
        raise AssertionError("the recompute phase did not advance per step")
    if img.device != dev or drained.light_volume.device != dev:
        raise AssertionError("the correlated update left the card")
    if not (bool(torch.isfinite(img).all())
            and bool(torch.isfinite(drained.light_volume).all())
            and 0.0 < alpha <= 1.0 + 1e-6):
        raise AssertionError("non-finite light volume or image, or alpha "
                             "outside (0, 1]")
    full_edit = step.full_trace_step(edited, state, config)
    moved = rel_l1(full_edit.light_volume, state.light_volume)
    left = rel_l1(drained.light_volume, full_edit.light_volume)
    print(f"the TF edit moves the light volume by rel L1 {moved:.3e}; the "
          f"drained volume is within {left:.3e} of a full retrace under the "
          f"edited TF (photons whose importance is 0 keep their paths)")

    # 3. The first batch's delta deposits: kernel (both designs) vs plain.
    pos, pw = batch_deposits(state, first, config)
    if pos.shape[0] != slots:
        raise AssertionError(f"{pos.shape[0]} delta slots, not {slots}")
    what = f"the {slots} signed delta slots of a default correlated step"
    on_delta, ref = check_on_list(what, pos, pw, r, dim, 50, tag)
    compare(first.light_volume, state.light_volume + ref,
            "first batch: light volume (kernel) vs previous + plain delta")
    del ref

    # 2. A grid of ones drained in two 50% batches equals a full trace; a
    # grid of zeros changes nothing. The stale state holds the photons of
    # another seed's trace and their light volume.
    half = dataclasses.replace(config, recompute=dataclasses.replace(
        config.recompute, max_photons_fraction=0.5))
    half_budget = step.recompute_budget(half, n)
    ones = dataclasses.replace(grid, data=torch.ones_like(grid.data))
    zeros = dataclasses.replace(grid, data=torch.zeros_like(grid.data))
    other = step.full_trace_step(scene, step.init_state(scene, config, seed=1),
                                 config)
    if torch.equal(other.photons.positions, state.photons.positions):
        raise AssertionError("another seed traced the same photons")
    stale = dataclasses.replace(other, key=state.key)
    reset_counts()
    s1 = step.correlated_step(scene, stale, half, ones, half_budget)
    s2 = step.correlated_step(scene, s1, half, ones, half_budget)
    expect_launches("two 50% batches", read_counts(), [sp.choose_design(
        2 * state.photons.max_interactions * half_budget, r, dim)] * 2)
    if s1.n_remaining != n - half_budget or s2.n_remaining != 0:
        raise AssertionError("two 50% batches did not drain a grid of ones")
    same = torch.equal(s2.photons.positions, state.photons.positions)
    err = float((s2.light_volume - state.light_volume).abs().max())
    print(f"grid of ones, two 50% batches vs full_trace_step: photons "
          f"bit-equal {same}, light volume max_abs_err {err:.3e} (max |ref| "
          f"{float(state.light_volume.abs().max()):.3e}; held to rtol "
          f"{DRAINED_RTOL}, atol {ATOL_REL} of that)")
    if not same:
        raise AssertionError("a drained grid of ones did not retrace the "
                             "full trace's photons")
    torch.testing.assert_close(
        s2.light_volume, state.light_volume, rtol=DRAINED_RTOL,
        atol=ATOL_REL * float(state.light_volume.abs().max()))
    unchanged = step.correlated_step(scene, state, config, zeros, budget)
    err = float((unchanged.light_volume - state.light_volume).abs().max())
    print(f"grid of zeros: light volume moved by {err:.3e}")
    if err >= UNCHANGED_ATOL or unchanged.n_remaining != 0:
        raise AssertionError("a grid of zeros changed the light volume")

    # 6. Stage times of one correlated step after the edit, beside a full
    # retrace (3 warm repetitions each, CUDA events).
    old = dataclasses.replace(state.photons, iteration=0, radius_rel=r)
    indices, valid, _ = select.select_photons_to_recompute(
        imp, budget, exclude=state.retraced)
    sub, safe = step.selected_samples(state.light_samples, indices, valid)
    key = rng.fold_in(state.key, 0)

    def retrace():
        return tracer.trace_photons(
            edited.volume, edited.tf, edited.tf_scattering, sub, key,
            config.tracer, lane_ids=safe)

    new = retrace()
    merged = tracer.merge_recomputed(old, new, indices, valid)
    stages = {
        "build_importance_grid": lambda: step.build_importance_grid(
            edited, config),
        "recompute_importance (path importance)":
            lambda: step.recompute_importance(config, grid, old,
                                              state.light_samples),
        "select_photons_to_recompute":
            lambda: select.select_photons_to_recompute(
                imp, budget, exclude=state.retraced),
        f"retrace of {budget} lanes (trace_photons)": retrace,
        "merge_recomputed": lambda: tracer.merge_recomputed(
            old, new, indices, valid),
        "splat_selected_delta (kernel)": lambda: splat.splat_selected_delta(
            old, merged, indices, valid, dim, method="cuda"),
        "splat_selected_delta (plain)": lambda: splat.splat_selected_delta(
            old, merged, indices, valid, dim, method="matmul"),
        "correlated_step": lambda: step.correlated_step(
            edited, state, config, grid, budget),
        "full_trace_step": lambda: step.full_trace_step(
            edited, state, config),
    }
    times = {name: cuda_ms(fn, reps=3) for name, fn in stages.items()}
    for name, t in times.items():
        print(f"correlated stage {name}: {t:.3f} ms ({tag})")
    # The two whole steps once more, in turns: the trace's host-bound time
    # drifts within a call.
    turns = [(name, cuda_ms(stages[name], reps=3, warmup=0))
             for name in ("correlated_step", "full_trace_step",
                          "full_trace_step", "correlated_step")]
    print("in turns: " + ", ".join(f"{name} {t:.3f} ms" for name, t in turns)
          + f" ({tag})")
    times["in_turns"] = turns
    waits = host_waits(stages["correlated_step"])
    in_trace = sum(host_waits(retrace).values())
    total = sum(waits.values())
    print(f"correlated_step retraces {int(valid.sum())} of {n} photons and "
          f"makes the host wait for the card {total} times, {in_trace} of "
          f"them inside the retrace (0: the sync debug mode reported none); "
          f"at "
          + ", ".join(f"{w} x{c}" for w, c in waits.most_common())
          + f" ({tag})")
    return {"launches": launches, "batches": batches, "slots": slots,
            "flagged": flagged, "on_delta": on_delta, "stage_ms": times,
            "delta_list": batch_deposits(state, first, config),
            "host_waits": total, "host_waits_in_retrace": in_trace,
            "drained": drained, "full_edit": full_edit}


def check_small_correlated(dev) -> None:
    """The same small correlated step (32^3, 32^2 photons, 2 interactions,
    a TF edit, one hot grid cell so fewer photons are flagged than a batch
    holds) on the card and on the CPU: selection equal, light volume within
    FRAME_REL_L1."""
    out = {}
    for device in (None, "cpu"):
        scene, config = build_frame(device, vol_dim=32, photons=32,
                                    max_interactions=2, width=32,
                                    fraction=0.5)
        state = step.full_trace_step(scene, step.init_state(scene, config),
                                     config)
        scene = edit_tf(scene)
        grid = step.build_importance_grid(scene, config)
        data = torch.zeros_like(grid.data)
        data[0, 3, 0] = 1.0
        grid = dataclasses.replace(grid, data=data)
        budget = step.recompute_budget(config, state.photons.n)
        imp = step.recompute_importance(config, grid, state.photons,
                                        state.light_samples)
        indices, valid, _ = select.select_photons_to_recompute(imp, budget)
        after = step.correlated_step(scene, state, config, grid, budget)
        out[device] = (indices[valid].cpu(), state, after)
    (sel, _, gpu), (cpu_sel, cpu_before, cpu) = out[None], out["cpu"]
    if gpu.light_volume.device != dev or cpu.light_volume.device.type != "cpu":
        raise AssertionError("a small correlated step ran on another device "
                             "than asked")
    moved = rel_l1(cpu.light_volume, cpu_before.light_volume)
    err = rel_l1(gpu.light_volume, cpu.light_volume)
    print(f"small correlated step, card vs CPU: {sel.shape[0]} photons "
          f"selected, the step moved the light volume by rel L1 {moved:.3e}, "
          f"card vs CPU rel L1 {err:.3e}")
    if not 0 < sel.shape[0] < budget or not torch.equal(sel, cpu_sel):
        raise AssertionError("the card and the CPU select other photons")
    if not (moved > 0.0 and err < FRAME_REL_L1):
        raise AssertionError("the card and the CPU disagree on a small "
                             "correlated step")


def correlated_large(scene, config, state, dev, tag) -> dict:
    """One ``correlated_step_scalable`` at the large frame after the TF
    edit, counted (first run only); its deposits (the removed and the added
    list, and the signed list of both that ``correlated_step`` would
    splat) through both designs and the plain version."""
    dim = step.light_volume_shape(config)
    r = f32_scalar(config.tracer.radius_rel)
    budget = step.recompute_budget(config, state.photons.n)
    half = state.photons.max_interactions * budget
    edited = edit_tf(scene)
    grid = step.build_importance_grid(edited, config)
    reset_counts()
    t0 = time.perf_counter()
    after = step.correlated_step_scalable(edited, state, config, grid, budget)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    pos, pw = batch_deposits(state, after, config)
    designs = [sp.choose_design(half, r, dim)] * 2
    print(f"large correlated_step_scalable (first run): budget {budget} of "
          f"{state.photons.n} photons, {after.n_remaining} remain, "
          f"{ms:.1f} ms; two splats of {half} slots -> {dim}, designs "
          f"{designs}, launches {launches} ({tag})")
    expect_launches("large correlated_step_scalable", launches, designs,
                    traces=1)
    if after.light_volume.device != dev or not bool(
            torch.isfinite(after.light_volume).all()):
        raise AssertionError("large correlated step: non-finite light "
                             "volume, or it left the card")
    on_signed, ref = check_on_list(
        f"the {2 * half} signed delta slots of a large correlated step", pos,
        pw, r, dim, 5, tag)
    compare(after.light_volume, state.light_volume + ref,
            "large correlated step: light volume (kernel) vs previous + "
            "plain delta")
    del ref
    on_added, _ = check_on_list(
        f"the {half} added slots of a large correlated_step_scalable",
        pos[half:], pw[half:], r, dim, 5, tag)
    return {"launches": launches, "slots": half, "on_added": on_added,
            "on_signed": on_signed, "first_run_ms": ms}


# --- time-varying playback and every emission mode -------------------------


def build_config4(device=None, dim=128, steps=32, photons=256,
                  max_interactions=4, max_steps=6000, fraction=0.1,
                  width=512, tf_points=None, volume_dim=None):
    """BASELINE config 4 (bench.py:343-373): the orbiting, pulsating sphere
    ``time_varying_sequence(dim, steps, seed=0)``, default TFs, one
    directional light at (0, -1, 0.3). Returns (the volumes as numpy,
    scene at step 0, config)."""
    vols = synthetic.time_varying_sequence(dim, steps, seed=0)
    tf = TransferFunction.from_points(
        *(tf_points or synthetic.default_tf_points()), device=device)
    tfs = TransferFunction.from_points(
        *synthetic.default_scattering_points(), device=device)
    scene = Scene.create(Volume.from_data(vols[0], device=device), tf, tfs,
                         [Light.directional((0.0, -1.0, 0.3))],
                         Camera.create(device=device))
    extra = {}
    if volume_dim:
        extra["splat"] = SplatConfig(volume_size_from_radius=False,
                                     volume_dim=volume_dim)
    config = PipelineConfig(
        photons_x=photons, photons_y=photons,
        tracer=TracerConfig(max_interactions=max_interactions,
                            max_steps=max_steps),
        recompute=RecomputeConfig(max_photons_fraction=fraction),
        render=RenderConfig(width=width, height=width), **extra)
    return vols, scene, config


def with_volume(scene, data):
    return dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, data=data))


def playback_config4(dev, tag) -> dict:
    """BASELINE config 4 at full width: 32 steps of 128^3, 256^2 photons x
    4 interactions, budget 10%. Prepare the sequence (timed), a full trace,
    then ``advance_time`` for t = 1..8 (one splat launch each, timed in
    turns with ``full_trace_step`` of the same step, both light volumes
    compared), two steps drained to the end against a full retrace, the
    host waits of one step, and the kernel on a step's own delta list."""
    vols, scene, config = build_config4()
    if scene.device != dev:
        raise AssertionError(f"a scene built with no device lies on "
                             f"{scene.device}, not on {dev}")
    seq, prep_ms = timed_once(lambda: tv.VolumeSequence.prepare(vols))
    state0, full0_ms = timed_once(lambda: step.full_trace_step(
        scene, step.init_state(scene, config), config))
    n = state0.photons.n
    budget = step.recompute_budget(config, n)
    dim = step.light_volume_shape(config)
    r = f32_scalar(config.tracer.radius_rel)
    slots = 2 * config.tracer.max_interactions * budget
    design = sp.choose_design(slots, r, dim)
    weights = ImportanceWeights().normalized()
    print(f"config 4: VolumeSequence.prepare of {tuple(seq.volumes.shape)} "
          f"(min/max {tuple(seq.minmax.shape)}, diff {tuple(seq.diff.shape)}) "
          f"{prep_ms:.1f} ms with the upload; first full_trace_step "
          f"{full0_ms:.1f} ms; budget {budget} of {n} photons, {slots} signed "
          f"delta slots a step -> {dim}, design {design} ({tag})")

    def grid_at(t):
        return tv.time_step_importance(
            seq.minmax, seq.diff, float(t), scene.tf.positions,
            scene.tf.colors, tuple(seq.volumes.shape[1:]), seq.cell_size,
            weights)

    # 1. Eight steps, one correlated batch each, in turns with a full
    # retrace of the same step.
    sc, st = scene, state0
    steps, launches = [], collections.Counter()
    for t in range(1, 9):
        before = dataclasses.replace(st, retraced=torch.zeros_like(
            st.retraced), n_remaining=0)
        reset_counts()
        (sc, st), ms = timed_once(
            lambda: tv.advance_time(sc, st, seq, float(t), config))
        counted = read_counts()
        expect_launches(f"advance_time to step {t}", counted, [design])
        launches.update(counted)
        full, full_ms = timed_once(lambda: step.full_trace_step(
            with_volume(scene, seq.volumes[t]), state0, config))
        if not torch.equal(sc.volume.data, seq.volumes[t]):
            raise AssertionError(f"advance_time to step {t} did not swap in "
                                 "that step's volume")
        err = rel_l1(st.light_volume, full.light_volume)
        stale = rel_l1(state0.light_volume, full.light_volume)
        steps.append({"t": t, "ms": ms, "full_ms": full_ms, "rel_l1": err,
                      "stale_rel_l1": stale, "n_remaining": st.n_remaining})
        print(f"config 4 step {t}: advance_time {ms:.1f} ms, full_trace_step "
              f"{full_ms:.1f} ms; rel L1 to the full retrace {err:.3e} "
              f"(stale map {stale:.3e}); {st.n_remaining} flagged photons "
              f"left; launches {counted} ({tag})")
        if not bool(torch.isfinite(st.light_volume).all()):
            raise AssertionError(f"step {t}: non-finite light volume")
        if st.recompute_phase != t:
            raise AssertionError("the recompute phase did not advance once "
                                 "per advance_time")
        if t == 1:
            first = (before, st, grid_at(1))
    del full

    # 2. The first two steps, each drained to the end.
    sc, st = scene, state0
    drains = []
    for t in (1, 2):
        grid = grid_at(t)
        flagged = int((step.recompute_importance(
            config, grid, st.photons, st.light_samples) > 0.0).sum())
        reset_counts()
        t0 = time.perf_counter()
        sc, st = tv.advance_time(sc, st, seq, float(t), config)
        batches = 1
        while st.n_remaining > 0:
            st = step.correlated_step(sc, st, config, grid, budget)
            batches += 1
            if batches > 4096:
                raise AssertionError("the drain did not converge")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counted = read_counts()
        full = step.full_trace_step(with_volume(scene, seq.volumes[t]),
                                    state0, config)
        err = rel_l1(st.light_volume, full.light_volume)
        want = -(-flagged // budget)
        drains.append({"t": t, "flagged": flagged, "batches": batches,
                       "ms": ms, "rel_l1": err})
        print(f"config 4 step {t} drained: {flagged} of {n} photons flagged, "
              f"{batches} batches in {ms:.1f} ms, launches {counted}; rel L1 "
              f"to the full retrace {err:.3e} (held to "
              f"{DRAINED_PLAYBACK_REL_L1}) ({tag})")
        if batches != want or flagged <= 0:
            raise AssertionError(f"step {t}: {batches} batches, not "
                                 f"ceil({flagged} / {budget}) = {want}")
        expect_launches(f"drain of step {t}", counted, [design] * batches)
        if not err < DRAINED_PLAYBACK_REL_L1:
            raise AssertionError(f"a drained playback step is {err:.3e} "
                                 "from a full retrace")
    del full

    # 3. Where one step makes the host wait for the card.
    before, after, grid = first
    waits = host_waits(lambda: tv.advance_time(scene, state0, seq, 1.0,
                                               config))
    total = sum(waits.values())
    print(f"config 4: one advance_time makes the host wait for the card "
          f"{total} times; at " + ", ".join(
              f"{w} x{c}" for w, c in waits.most_common(8)) + f" ({tag})")

    # 4. The kernel on the first step's own signed delta list.
    imp = step.recompute_importance(config, grid, before.photons,
                                    before.light_samples)
    pos, pw = batch_deposits(before, after, config)
    if pos.shape[0] != slots:
        raise AssertionError(f"{pos.shape[0]} delta slots, not {slots}")
    on_delta, ref = check_on_list(
        f"the {slots} signed delta slots of a config 4 playback step", pos,
        pw, r, dim, 50, tag)
    compare(after.light_volume, before.light_volume + ref,
            "config 4 step 1: light volume (kernel) vs previous + plain delta")
    del ref

    # 5. The stages of that step, 3 warm repetitions each, beside a full
    # retrace of the same step.
    indices, valid, _ = select.select_photons_to_recompute(
        imp, budget, exclude=before.retraced)
    sub, safe = step.selected_samples(before.light_samples, indices, valid)
    scene1 = with_volume(scene, seq.volumes[1])
    old = dataclasses.replace(before.photons, iteration=0, radius_rel=r)
    key = rng.fold_in(before.key, 0)

    def retrace():
        return tracer.trace_photons(
            scene1.volume, scene1.tf, scene1.tf_scattering, sub, key,
            config.tracer, lane_ids=safe)

    merged = tracer.merge_recomputed(old, retrace(), indices, valid)
    trace_check = check_trace(
        f"config 4 step 1 retrace of {budget} lanes", scene1, sub, key,
        config.tracer, dim, tag, lane_ids=safe, timed=True)
    step_in_turns = []
    for m in TRACE_TURNS:
        with traced_by(m):
            step_in_turns.append((m, cuda_ms(lambda: tv.advance_time(
                scene, before, seq, 1.0, config), reps=2)))
    print("config 4 advance_time in turns: " + ", ".join(
        f"{m} {t:.3f} ms" for m, t in step_in_turns) + f" ({tag})")
    stages = {
        "sequence_sample (mix)": lambda: mixer.sequence_sample(
            seq.volumes, 1.5),
        "time_step_importance": lambda: grid_at(1),
        "recompute_importance (path importance)":
            lambda: step.recompute_importance(config, grid, old,
                                              before.light_samples),
        "select_photons_to_recompute":
            lambda: select.select_photons_to_recompute(
                imp, budget, exclude=before.retraced),
        f"retrace of {budget} lanes (trace_photons)": retrace,
        "merge_recomputed": lambda: tracer.merge_recomputed(
            old, merged, indices, valid),
        "splat_selected_delta (kernel)": lambda: splat.splat_selected_delta(
            old, merged, indices, valid, dim, method="cuda"),
        "advance_time": lambda: tv.advance_time(scene, before, seq, 1.0,
                                                config),
        "full_trace_step": lambda: step.full_trace_step(scene1, state0,
                                                        config),
    }
    stage_ms = {name: cuda_ms(fn, reps=3) for name, fn in stages.items()}
    for name, t in stage_ms.items():
        print(f"config 4 stage {name}: {t:.3f} ms ({tag})")

    # 6. The wavefront statistics of that step's retrace.
    stats = trace_stats(
        f"the retrace of {budget} lanes in config 4 step 1",
        lambda on: tracer.trace_photons(
            scene1.volume, scene1.tf, scene1.tf_scattering, sub, key,
            config.tracer, lane_ids=safe, return_stats=on),
        config.tracer.flights_per_iteration, tag)
    del seq, merged
    torch.cuda.empty_cache()
    return {"launches": dict(launches), "steps": steps, "drains": drains,
            "host_waits": total, "on_delta": on_delta, "prepare_ms": prep_ms,
            "stage_ms": stage_ms, "trace_stats": stats,
            "trace_check": trace_check, "step_in_turns": step_in_turns}


def check_small_playback(dev) -> None:
    """A small playback (48^3 x 24 steps, 32^2 photons, 2 interactions, the
    reference's tests/test_timevarying.py:26-65 setup) on the card and on
    the CPU: light volumes within FRAME_REL_L1 after each of two steps."""
    flat_step = ([0.0, 0.3, 0.32, 1.0],
                 [(0.2, 0.2, 0.2, 0.0), (0.2, 0.2, 0.2, 0.0),
                  (0.9, 0.8, 0.7, 0.5), (1.0, 1.0, 1.0, 0.8)])
    out = {}
    for device in (None, "cpu"):
        vols, scene, config = build_config4(
            device, dim=48, steps=24, photons=32, max_interactions=2,
            max_steps=1500, fraction=1.0, width=24, tf_points=flat_step,
            volume_dim=16)
        seq = tv.VolumeSequence.prepare(vols, device=device)
        st = step.full_trace_step(scene, step.init_state(scene, config),
                                  config)
        lvs = []
        for t in (1, 2):
            scene, st = tv.advance_time(scene, st, seq, float(t), config)
            lvs.append(st.light_volume)
        out[device] = lvs
    if out[None][0].device != dev or out["cpu"][0].device.type != "cpu":
        raise AssertionError("a small playback ran on another device than "
                             "asked")
    errs = [rel_l1(a, b) for a, b in zip(out[None], out["cpu"])]
    print(f"small playback, card vs CPU: light volume rel L1 "
          + ", ".join(f"{e:.3e}" for e in errs) + " (light volume sums "
          + ", ".join(f"{float(b.sum()):.6g}" for b in out["cpu"]) + ")")
    if not max(errs) < FRAME_REL_L1:
        raise AssertionError("the card and the CPU disagree on a small "
                             "playback")


def build_config3(device=None, dim=256, photons=256):
    """BASELINE config 3 (bench.py:173-203): ``ct_head_like(256)``, default
    TFs, one directional light at (0.2, -1, 0.3), 256^2 photons x 4
    interactions, max_steps 8000, a 512^2 image."""
    volume = Volume.from_data(synthetic.ct_head_like(dim), device=device)
    tf = TransferFunction.from_points(*synthetic.default_tf_points(),
                                      device=device)
    tfs = TransferFunction.from_points(
        *synthetic.default_scattering_points(), device=device)
    scene = Scene.create(volume, tf, tfs,
                         [Light.directional((0.2, -1.0, 0.3))],
                         Camera.create(device=device))
    config = PipelineConfig(
        photons_x=photons, photons_y=photons,
        tracer=TracerConfig(max_interactions=4, max_steps=8000),
        recompute=RecomputeConfig(max_photons_fraction=0.1),
        render=RenderConfig(width=512, height=512))
    return scene, config


GUIDE_FLOOR = 0.25  # bench.py:204


def guided_config3(dev, tag) -> dict:
    """BASELINE config 3: an importance-guided frame (counted), the kernel
    on its deposits, a pilot wave and its contribution guide, six uniform
    and six guided waves (variance ratio and bias), and three ticks of
    ``progressive_step_guided``."""
    scene, config = build_config3()
    if scene.device != dev:
        raise AssertionError(f"a scene built with no device lies on "
                             f"{scene.device}, not on {dev}")
    light = scene.lights[0]
    dim = step.light_volume_shape(config)
    guided = dataclasses.replace(config, guided_emission=True)

    # 1. The importance-guided frame, counted.
    grid = step.build_importance_grid(scene, config)
    reset_counts()
    t0 = time.perf_counter()
    state = step.init_state(scene, guided, importance_grid=grid)
    state = step.full_trace_step(scene, state, guided)
    img = step.render_state(scene, state, guided)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    frame_launches = read_counts()
    print(f"config 3 guided frame (first run): {ms:.1f} ms ({tag})")
    expect_frame("config 3 guided frame", guided, state, img, dev,
                 frame_launches)
    sweep_check = check_sweep("config 3 guided frame", scene.volume,
                              scene.tf, state.light_volume_accum,
                              scene.camera, guided.render, tag, timed=True)
    uniform = step.init_state(scene, config).light_samples
    if torch.equal(state.light_samples.origins, uniform.origins):
        raise AssertionError("guided emission did not move the samples")
    pos, pw = splat.product_deposits(state.photons)
    on_frame, _ = check_on_list(
        f"the {pos.shape[0]} deposit slots of the config 3 guided frame",
        pos, pw, state.photons.radius_rel, dim, 50, tag)
    trace_check = check_trace(
        f"config 3 guided frame ({state.light_samples.n} lanes, 256^3)",
        scene, state.light_samples, rng.fold_in(state.key, 0),
        guided.tracer, dim, tag, timed=True)
    stages = {
        "build_importance_grid": lambda: step.build_importance_grid(
            scene, config),
        "init_state (guided emit)": lambda: step.init_state(
            scene, guided, importance_grid=grid),
        "full_trace_step": lambda: step.full_trace_step(scene, state, guided),
        "render_state": lambda: step.render_state(scene, state, guided)}
    stage_ms = {name: cuda_ms(fn, reps=3) for name, fn in stages.items()}
    for name, t in stage_ms.items():
        print(f"config 3 stage {name}: {t:.3f} ms ({tag})")
    del img, pos, pw

    # 2. Adaptive waves (bench.py:206-243): a pilot wave, its contribution
    # guide, six uniform and six guided waves of equal photon count.
    def wave(guide, seed):
        g = sampling.stratified_grid_2d(config.photons_x, config.photons_y)
        if guide is not None:
            g = sampling.warp_samples_2d(g, guide, floor=GUIDE_FLOOR)
        ls = emit.emit(light, g, key=rng.fold_in(rng.prng_key(seed), 7))
        st = step.init_state(scene, config, seed=seed, light_samples=ls)
        reset_counts()
        st = step.full_trace_step(scene, st, config)
        expect_launches(f"wave of seed {seed}", read_counts(), [
            sp.choose_design(st.photons.positions.shape[0] * st.photons.n,
                             st.photons.radius_rel, dim)])
        return st, g

    t0 = time.perf_counter()
    pilot, pilot_grid = wave(None, 999)
    guide = emit.emission_guide_from_wave(
        pilot_grid[:, 0:2], pilot_grid[:, 3], pilot.photons.powers, 64, 64)
    lv_u = [wave(None, s)[0].light_volume.cpu().numpy() for s in range(6)]
    lv_g = [wave(guide, s)[0].light_volume.cpu().numpy() for s in range(6)]
    waves_s = time.perf_counter() - t0
    mean_u = np.mean(lv_u, axis=0)
    bright = mean_u.sum(-1) > np.percentile(mean_u.sum(-1), 90)

    def relvar(waves):
        s = np.stack([w.sum(-1)[bright] for w in waves])
        return float(np.mean(s.var(0) / np.maximum(s.mean(0), 1e-12) ** 2))

    var_u, var_g = relvar(lv_u), relvar(lv_g)
    bias = float(abs(np.mean([x.sum() for x in lv_g])
                     / max(np.mean([x.sum() for x in lv_u]), 1e-9) - 1.0))
    print(f"config 3 waves: pilot + 6 uniform + 6 guided (floor "
          f"{GUIDE_FLOOR}) in {waves_s:.1f} s, one launch each; bright-cell "
          f"relative variance uniform {var_u:.6f}, guided {var_g:.6f}, ratio "
          f"{var_u / max(var_g, 1e-12):.3f}; total-irradiance bias "
          f"{bias:.4f} (held to {GUIDED_BIAS}) ({tag})")
    if not bias < GUIDED_BIAS:
        raise AssertionError(f"guided emission is biased by {bias:.4f}")

    # The guided samples as the debug image (SamplesToImage): normalized,
    # its mean is 1.
    warped = sampling.warp_samples_2d(sampling.stratified_grid_2d(
        config.photons_x, config.photons_y), guide, floor=GUIDE_FLOOR)
    image, image_ms = timed_once(
        lambda: debug.samples_to_image(warped, DEBUG_SIDE, DEBUG_SIDE))
    mean = float(image.mean())
    print(f"config 3 guided samples as a {DEBUG_SIDE}^2 debug image: "
          f"{image_ms:.3f} ms; mean {mean:.7f}, min {float(image.min()):.4f}, "
          f"max {float(image.max()):.4f} ({tag})")
    if image.device != dev or not abs(mean - 1.0) < 1e-5:
        raise AssertionError("the debug image of the guided samples does not "
                             "have a mean of 1, or left the card")

    # 3. Three ticks of progressive_step_guided from the pilot's state.
    st, g = pilot, None
    tick_ms = []
    for tick in range(1, 4):
        (st, g), ms = timed_once(lambda: step.progressive_step_guided(
            scene, st, config, guide=g))
        tick_ms.append(ms)
        if st.photons.iteration != tick or not bool(
                torch.isfinite(st.light_volume_accum).all()) or not float(
                g.max()) > 0.0:
            raise AssertionError(f"progressive_step_guided tick {tick}")
    print(f"config 3 progressive_step_guided: 3 ticks "
          + ", ".join(f"{t:.1f}" for t in tick_ms) + f" ms; next guide max "
          f"{float(g.max()):.4g} ({tag})")
    del pilot, st, state, grid
    torch.cuda.empty_cache()
    return {"launches": frame_launches, "on_frame": on_frame,
            "stage_ms": stage_ms, "variance_uniform": var_u,
            "variance_guided": var_g, "bias": bias, "tick_ms": tick_ms,
            "debug_image_ms": image_ms, "trace_check": trace_check,
            "sweep_check": sweep_check}


# Every other light type and the Hilbert order at the default scene.
OTHER_LIGHTS = {
    "point light": (Light.point((0.5, 0.9, 0.5)), {}),
    "cone light": (Light.cone((0.5, 1.4, 0.5), (0.0, -1.0, 0.0)), {}),
    "area light": (Light.area((0.5, 1.4, 0.5), (0.0, -1.0, 0.0)), {}),
    "directional light, Hilbert order": (
        Light.directional((0.0, -1.0, 0.3)), {"sample_order": "hilbert"}),
}


def other_lights(dev, tag) -> dict:
    """init_state -> full_trace_step -> render_state at the default frame
    for a point, a cone and an area light, and for the directional light
    in Hilbert order, each counted and held against the plain splat."""
    scene, config = build_frame()
    out = {}
    for what, (light, extra) in OTHER_LIGHTS.items():
        lit = dataclasses.replace(scene, lights=(light,))
        cfg = dataclasses.replace(config, **extra)
        reset_counts()
        (state, img), ms = timed_once(lambda: run_frame(lit, cfg))
        counted = read_counts()
        print(f"{what} frame: {ms:.1f} ms ({tag})")
        expect_frame(f"{what} frame", cfg, state, img, dev, counted)
        out[what] = {"ms": ms, "launches": counted}
    return out


# --- the tracer's forward options, the gather marcher, screen-space
# importance, NEE, mesh spans and the debug image ---------------------------

PHOTON_FIELDS = ("positions", "powers", "directions", "exit_power",
                 "exit_direction")
# Float16 photon storage against float32 (tests/test_misc_parity.py:32-48):
# positions within the ~2^-11 quantization, the light volume within 2%
# relative L1. The largest finite float16; a stored power above it is +inf.
F16_POS_ATOL = 1e-3
F16_FRAME_REL_L1 = 0.02
F16_MAX = 65504.0
# The marcher's dense form against its loop form, and the sweep's
# intermediate image against its oracle (tests/test_sweep.py:71-72), each
# on CHECK_RAYS rays of the default frame.
DENSE_RTOL, DENSE_ATOL = 1e-4, 1e-6
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 5e-5
CHECK_RAYS = 4096
# The eye inside the volume: the two-pass sweep against the marcher at 512
# steps (tests/test_sweep.py:134-148): mean |diff| under INSIDE_MEAN and
# correlation over INSIDE_CORR off a rim of INSIDE_RIM pixels. That test's
# light volume (uniform x 0.4 on 16^3) is held to its absolute bound; the
# frame's light volume, whose image values reach ~10^3, to the bound times
# the marcher's mean |value| (as tests/test_sweep.py:113-116 holds the
# sweep's image to the marcher's).
INSIDE_MEAN, INSIDE_CORR, INSIDE_RIM = 0.02, 0.98, 4
INSIDE_SIDE, INSIDE_STEPS = 256, 512
SCREEN_WEIGHT = 0.5
GRID_RTOL = 1e-5
# A narrow camera, whose rays miss part of the volume: there the
# camera-visibility term is below 1 in some visible cells.
NARROW_FOV = 12.0
NEE_STEPS = 64
# A ray through an edge of the box mesh hits both triangles there (three
# or four hits, so the odd-count rule may call it inside); the reference's
# test lets 1% of the hit set differ (tests/test_intersect_mesh.py:37-38).
MESH_EDGE_FRACTION = 0.01
DEBUG_SIDE = 256


def used_slots(photons) -> torch.Tensor:
    """(I, N) True where a deposit is stored (float16's sentinel is +inf)."""
    return photons.positions[..., 0].float() < 1e30


def photon_bytes(photons) -> int:
    return sum(getattr(photons, f).numel() * getattr(photons, f).element_size()
               for f in PHOTON_FIELDS)


def lanes(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The rows of the lanes in ``mask`` of a photon field: (I, N, ...)
    fields hold lanes on their second axis, the exit fields on the first."""
    return t[:, mask] if t.dim() == 3 else t[mask]


def expect_cast(p32, p16, what: str) -> float:
    """The float16 trace is the float32 trace cast: its three deposit fields
    equal the float32 ones cast bit for bit (FLT_MAX and powers above
    F16_MAX become +inf), the exit fields are equal, the deposit set is the
    same, and the positions lie within F16_POS_ATOL. Returns the largest
    position difference."""
    for f in ("positions", "powers", "directions"):
        got, want = getattr(p16, f), getattr(p32, f)
        if got.dtype != torch.float16 or not torch.equal(got, want.half()):
            raise AssertionError(f"{what}: float16 {f} are not the float32 "
                                 "trace's cast")
    for f in ("exit_power", "exit_direction"):
        if not torch.equal(getattr(p16, f), getattr(p32, f)):
            raise AssertionError(f"{what}: float16 run's {f} differ")
    used = used_slots(p32)
    if not torch.equal(used, used_slots(p16)):
        raise AssertionError(f"{what}: the deposit sets differ")
    err = float((p16.positions.float() - p32.positions)[used].abs().max())
    if not err <= F16_POS_ATOL:
        raise AssertionError(f"{what}: positions differ by {err:.3e}")
    return err


def float16_frames(dev, tag) -> dict:
    """Float16 photon storage. (1) The default frame's trace in float32 and
    in float16 under one key: the float16 fields are the float32 ones cast
    (``expect_cast``); at 4 interactions some stored powers exceed F16_MAX
    and become +inf, in the reference as here; the sweep kernel on that
    light volume against the plain loop, NaN equal. (2) The default frame
    at 2 interactions, where every stored power fits (a deposit divides the
    power by an opacity of at least 0.01: at most 1.2452 / 2 x 100^2 =
    6,226), counted: the cast again, the light volume within
    F16_FRAME_REL_L1 of float32's, both designs against the plain version
    on its deposits, whose unused slots are +inf, and both frames timed in
    turns. (3) Its correlated update after the TF edit, drained through
    ``step()`` and counted: every flagged photon equals the float16 full
    retrace's bit for bit and every other one is unchanged; the first
    batch's signed delta list through both designs; a grid of ones drained
    in two 50% batches equals the full trace (photons bit for bit, the
    light volume within DRAINED_RTOL, ATOL_REL x its peak)."""
    # 1. The default frame's trace at 4 interactions.
    scene, config = build_frame()
    init = step.init_state(scene, config)
    key = rng.fold_in(init.key, 0)

    def trace(cfg):
        return tracer.trace_photons(scene.volume, scene.tf,
                                    scene.tf_scattering, init.light_samples,
                                    key, cfg.tracer)

    p32 = trace(config)
    p16 = trace(with_tracer(config, photon_dtype="float16"))
    pos_err = expect_cast(p32, p16, "default frame, 4 interactions")
    used = used_slots(p32)
    over = int(((p32.powers.abs() > F16_MAX).any(-1) & used).sum())
    inf = int((torch.isinf(p16.powers).any(-1) & used).sum())
    print(f"float16 trace of the default frame (4 interactions): "
          f"{int(used.sum())} deposits, the float32 trace's cast bit for bit "
          f"(positions within {pos_err:.3e}); {over} of them carry a power "
          f"above {F16_MAX:g}, stored as +inf ({inf}); photon buffers "
          f"{photon_bytes(p32)} B in float32, {photon_bytes(p16)} B in "
          f"float16 ({tag})")
    if over != inf:
        raise AssertionError("the overflowing powers are not the +inf ones")
    # Its light volume holds +inf, and 0 x inf is NaN: the plain loop's
    # matrix products meet every texel of a plane's slab with every ray,
    # and the kernel gives NaN where they do. Held with NaN equal.
    lv_inf = splat.splat_all(p16, step.light_volume_shape(config),
                             method="cuda")
    n_inf = int(torch.isinf(lv_inf).sum())
    inf_check = check_sweep(
        f"float16 light volume at 4 interactions ({n_inf} infinite texels)",
        scene.volume, scene.tf, lv_inf, scene.camera, config.render, tag)
    inf_nan = inf_check["nan_pixels"]
    print(f"float16 light volume at 4 interactions: {n_inf} infinite "
          f"texels; NaN pixels of the {config.render.width}^2 image: kernel "
          f"{inf_nan['cuda']}, plain loop {inf_nan['torch']} ({tag})")
    if inf_nan["cuda"] != inf_nan["torch"]:
        raise AssertionError("the kernel's NaN pixels are not the plain "
                             "loop's")
    del p32, p16, lv_inf

    # 2. The counted float16 frame at 2 interactions.
    scene, config = build_frame(max_interactions=2)
    half = with_tracer(config, photon_dtype="float16")
    dim = step.light_volume_shape(config)
    s32, _ = run_frame(scene, config)
    reset_counts()
    (s16, img), ms = timed_once(lambda: run_frame(scene, half))
    launches = read_counts()
    print(f"float16 frame, 2 interactions (first run): {ms:.1f} ms ({tag})")
    expect_frame("float16 frame, 2 interactions", half, s16, img, dev,
                 launches)
    sweep_check = check_sweep("float16 frame, 2 interactions", scene.volume,
                              scene.tf, s16.light_volume_accum, scene.camera,
                              half.render, tag)
    pos_err = expect_cast(s32.photons, s16.photons,
                          "default frame, 2 interactions")
    biggest = float(s32.photons.powers[used_slots(s32.photons)].max())
    lv_err = rel_l1(s16.light_volume, s32.light_volume)
    print(f"float16 frame vs float32 under one key: positions within "
          f"{pos_err:.3e}, largest power {biggest:.6g}, light volume rel L1 "
          f"{lv_err:.3e} (held to {F16_FRAME_REL_L1}); photon buffers "
          f"{photon_bytes(s32.photons)} B in float32, "
          f"{photon_bytes(s16.photons)} B in float16")
    if not lv_err < F16_FRAME_REL_L1:
        raise AssertionError("the float16 frame's light volume is off")
    pos, pw = splat.product_deposits(s16.photons)
    unused = int(torch.isinf(pos[:, 0]).sum())
    if unused != pos.shape[0] - int(used_slots(s16.photons).sum()):
        raise AssertionError("the float16 frame's unused slots do not reach "
                             "the kernel as +inf")
    on_frame, _ = check_on_list(
        f"the {pos.shape[0]} slots of the float16 frame ({unused} unused, "
        "at +inf)", pos, pw, s16.photons.radius_rel, dim, 50, tag)
    turns = [(name, cuda_ms(lambda c=c: run_frame(scene, c), reps=3))
             for name, c in (("float32", config), ("float16", half),
                             ("float16", half), ("float32", config))]
    print("frames in turns, 2 interactions: " + ", ".join(
        f"{name} {t:.3f} ms" for name, t in turns) + f" ({tag})")

    # 3. Its correlated update after the TF edit, drained and counted.
    n = s16.photons.n
    budget = step.recompute_budget(half, n)
    r = f32_scalar(config.tracer.radius_rel)
    slots = 2 * half.tracer.max_interactions * budget
    design = sp.choose_design(slots, r, dim)
    edited = edit_tf(scene)
    grid = step.build_importance_grid(edited, half)
    flagged = step.recompute_importance(half, grid, s16.photons,
                                        s16.light_samples) > 0.0
    want_batches = -(-int(flagged.sum()) // budget)
    reset_counts()
    (drained, first, batches), drain_ms = timed_once(
        lambda: drain(edited, half, s16, grid))
    drain_launches = read_counts()
    print(f"float16 correlated drain after the TF edit (first run): "
          f"{int(flagged.sum())} of {n} photons flagged, budget {budget}, "
          f"{batches} batches in {drain_ms:.1f} ms; {slots} signed delta "
          f"slots a batch, design {design}, launches {drain_launches} ({tag})")
    if batches != want_batches:
        raise AssertionError(f"the float16 drain took {batches} batches, not "
                             f"{want_batches}")
    expect_launches("float16 drain", drain_launches, [design] * batches)
    if drained.photons.positions.dtype != torch.float16 or not bool(
            torch.isfinite(drained.light_volume).all()):
        raise AssertionError("the float16 drain changed the storage type or "
                             "left a non-finite light volume")
    full = step.full_trace_step(edited, s16, half)
    for f in PHOTON_FIELDS:
        got = getattr(drained.photons, f)
        if not (torch.equal(lanes(got, flagged),
                            lanes(getattr(full.photons, f), flagged))
                and torch.equal(lanes(got, ~flagged),
                                lanes(getattr(s16.photons, f), ~flagged))):
            raise AssertionError(f"float16 drain: {f} of the flagged photons "
                                 "differ from the full retrace's, or others "
                                 "moved")
    print(f"float16 drain: flagged photons equal the full retrace's bit for "
          f"bit, the others are unchanged; light volume rel L1 to the full "
          f"retrace {rel_l1(drained.light_volume, full.light_volume):.3e}")
    pos, pw = batch_deposits(s16, first, half)
    on_delta, ref = check_on_list(
        f"the {slots} signed delta slots of a float16 correlated step", pos,
        pw, r, dim, 50, tag)
    compare(first.light_volume, s16.light_volume + ref,
            "float16 first batch: light volume (kernel) vs previous + plain "
            "delta")
    del ref, full, drained, first

    halves = dataclasses.replace(half, recompute=dataclasses.replace(
        half.recompute, max_photons_fraction=0.5))
    half_budget = step.recompute_budget(halves, n)
    ones = dataclasses.replace(grid, data=torch.ones_like(grid.data))
    other = step.full_trace_step(scene, step.init_state(scene, half, seed=1),
                                 half)
    state = dataclasses.replace(other, key=s16.key)
    for _ in range(2):
        state = step.correlated_step(scene, state, halves, ones, half_budget)
    same = all(torch.equal(getattr(state.photons, f), getattr(s16.photons, f))
               for f in PHOTON_FIELDS)
    peak = float(s16.light_volume.abs().max())
    err = float((state.light_volume - s16.light_volume).abs().max())
    print(f"float16 grid of ones, two 50% batches vs full_trace_step: "
          f"photons bit-equal {same}, light volume max_abs_err {err:.3e} "
          f"(max |ref| {peak:.3e})")
    if not same or state.n_remaining != 0:
        raise AssertionError("a drained float16 grid of ones did not retrace "
                             "the full trace's photons")
    torch.testing.assert_close(state.light_volume, s16.light_volume,
                               rtol=DRAINED_RTOL, atol=ATOL_REL * peak)
    del scene, s32, s16, other, state
    torch.cuda.empty_cache()
    return {"launches": launches, "on_frame": on_frame, "first_run_ms": ms,
            "in_turns": turns, "light_volume_rel_l1": lv_err,
            "drain_launches": drain_launches, "batches": batches,
            "on_delta": on_delta, "drain_ms": drain_ms,
            "overflow_at_4_interactions": over, "sweep_check": sweep_check,
            "sweep_nan_pixels_at_4_interactions": inf_nan,
            "sweep_check_at_4_interactions": inf_check}


def no_single_scattering_frame(dev, tag) -> dict:
    """The default frame without single scattering, counted: deposits > 0,
    the kernel on its deposits against the plain version, and the small
    frame's trace on the card against the CPU's."""
    scene, config = build_frame()
    nss = with_tracer(config, no_single_scattering=True)
    reset_counts()
    (state, img), ms = timed_once(lambda: run_frame(scene, nss))
    launches = read_counts()
    print(f"no-single-scattering frame (first run): {ms:.1f} ms ({tag})")
    expect_frame("no-single-scattering frame", nss, state, img, dev, launches)
    pos, pw = splat.product_deposits(state.photons)
    on_frame, _ = check_on_list(
        f"the {pos.shape[0]} slots of the no-single-scattering frame", pos,
        pw, state.photons.radius_rel, step.light_volume_shape(config), 50,
        tag)
    frame_ms = cuda_ms(lambda: run_frame(scene, nss), reps=3)
    print(f"no-single-scattering frame: {frame_ms:.3f} ms warm ({tag})")
    check_small_frame(dev, no_single_scattering=True)
    del scene, state, img
    return {"launches": launches, "on_frame": on_frame, "first_run_ms": ms,
            "frame_ms": frame_ms}


def trace_stats(what: str, trace, k: int, tag) -> dict:
    """``trace(return_stats)`` with the statistics on and off: the photons
    are equal bit for bit, the stats add at most one host wait (the
    kernel's path reads the flights back once), the active history's
    last nonzero slot is one of the last group of ``k`` flights (the loop
    tests for active lanes once a group; a group's later flights may find
    none), or 511 once the flights outnumber the slots, and its sum over
    flights x lanes is the mean active fraction."""
    plain = trace(False)
    photons, stats = trace(True)
    for f in PHOTON_FIELDS:
        if not torch.equal(getattr(photons, f), getattr(plain, f)):
            raise AssertionError(f"{what}: return_stats changed the {f}")
    waits = {on: sum(host_waits(lambda on=on: trace(on)).values())
             for on in (False, True)}
    times = [(on, cuda_ms(lambda on=on: trace(on), reps=3))
             for on in (False, True, True, False)]
    iters = stats["wavefront_iters"]
    hist = stats["active_history"].cpu()
    nonzero = torch.nonzero(hist)[:, 0]
    last = int(nonzero[-1])
    frac = float(stats["mean_active_frac"])
    n = photons.n
    print(f"trace statistics of {what}: {iters} flights, mean active "
          f"fraction {frac:.6f}, stage widths {stats['stage_widths']}; host "
          f"waits without / with the statistics {waits[False]} / "
          f"{waits[True]}; trace in turns "
          + ", ".join(f"{'with' if on else 'without'} {t:.3f} ms"
                      for on, t in times)
          + f"; active lanes by flight {hist[:last + 1].tolist()} ({tag})")
    want = [511] if iters > 512 else list(range(max(iters - k, 0), iters))
    if last not in want:
        raise AssertionError(f"{what}: the history's last nonzero slot is "
                             f"{last}, not one of {want}")
    if waits[True] > waits[False] + 1:
        raise AssertionError(f"{what}: the statistics add more than the "
                             "one host wait that reads the flights")
    if stats["stage_widths"] != [n] or not 0.0 < frac <= 1.0 or not math.isclose(
            float(hist.sum()) / (max(iters, 1) * n), frac, rel_tol=1e-6):
        raise AssertionError(f"{what}: inconsistent statistics")
    return {"wavefront_iters": iters, "mean_active_frac": frac,
            "active_history": hist[:last + 1].tolist(), "host_waits": waits,
            "trace_ms_in_turns": times}


def intermediate_rays(camera, inter, grid, axis: int, n: int, dev):
    """``n`` seeded pixels of the sweep's intermediate image and the rays
    from the eye through their centres on the first plane
    (tests/test_sweep.py:31-49): (pixel indices, origins, directions,
    plane positions), on ``dev``."""
    u_lo, u_hi, v_lo, v_hi, za = (x.detach().cpu().numpy() for x in grid)
    rows, cols = inter.shape[:2]
    idx = np.random.default_rng(1).choice(rows * cols, n, replace=False)
    b_axis, c_axis = [i for i in range(3) if i != axis]
    p = np.zeros((n, 3), np.float32)
    p[:, axis] = za[0]
    p[:, b_axis] = u_lo + ((idx % cols).astype(np.float32) + 0.5) / cols * (
        u_hi - u_lo)
    p[:, c_axis] = v_lo + ((idx // cols).astype(np.float32) + 0.5) / rows * (
        v_hi - v_lo)
    o = np.broadcast_to(camera.host("eye"), p.shape).astype(np.float32)
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(o).to(dev),
            torch.from_numpy(p - o).to(dev), torch.from_numpy(za).to(dev))


def eye_inside(scene, light_volume, dev, tag) -> dict:
    """The eye-inside camera at INSIDE_SIDE^2: the two-pass sweep against
    the marcher at INSIDE_STEPS steps, on the test's light volume and on
    the frame's."""
    camera = Camera.create(eye=(0.5, 0.5, 0.45), center=(0.5, 0.5, 2.0))
    rc = RenderConfig(width=INSIDE_SIDE, height=INSIDE_SIDE,
                      sampling_rate=4.0)
    test_lv = torch.from_numpy(np.random.default_rng(7).random(
        (16, 16, 16, 3), dtype=np.float32) * 0.4).to(dev)
    out = {}
    c = INSIDE_RIM
    for what, lv in (("the test's light volume", test_lv),
                     ("the frame's light volume", light_volume)):
        swept, sweep_ms = timed_once(lambda: sweep_render.sweep_render(
            scene.volume, scene.tf, lv, camera, rc))
        marched, march_ms = timed_once(lambda: gather.render(
            scene.volume, scene.tf, lv, camera, rc, n_steps=INSIDE_STEPS))
        a, b = swept[c:-c, c:-c], marched[c:-c, c:-c]
        mean = float((a - b).abs().mean())
        corr = float(torch.corrcoef(torch.stack(
            [a[..., :3].reshape(-1), b[..., :3].reshape(-1)]))[0, 1])
        scale = 1.0 if lv is test_lv else float(b.abs().mean())
        print(f"eye inside, {what}, {INSIDE_SIDE}^2: sweep (two passes) "
              f"{sweep_ms:.1f} ms, marcher ({INSIDE_STEPS} steps) "
              f"{march_ms:.1f} ms (first runs); mean |diff| {mean:.4e} (held "
              f"to {INSIDE_MEAN * scale:.4e}), correlation {corr:.6f} ({tag})")
        if not (float(swept[..., 3].sum()) > 0.0
                and mean < INSIDE_MEAN * scale and corr > INSIDE_CORR):
            raise AssertionError(f"eye inside, {what}: the sweep and the "
                                 "marcher disagree")
        out[what] = {"mean_abs_diff": mean, "correlation": corr,
                     "sweep_ms": sweep_ms, "march_ms": march_ms}
    return out


def march_frame(dev, tag) -> dict:
    """The default frame rendered by the gather marcher, counted; the dense
    marcher against its loop twin and the sweep's intermediate image
    against its oracle on CHECK_RAYS rays each; both renderers timed in
    turns (march, sweep, sweep, march); the eye-inside camera."""
    scene, config = build_frame()
    march = with_render(config, method="march")
    reset_counts()
    (state, img), ms = timed_once(lambda: run_frame(scene, march))
    launches = read_counts()
    vol, tf, camera = scene.volume, scene.tf, scene.camera
    lv, rc = state.light_volume_accum, config.render
    n_steps = gather.default_steps(vol, rc.sampling_rate)
    npix = rc.width * rc.height
    chunk = gather.chunk_size(n_steps)
    print(f"march-rendered frame (first run): {ms:.1f} ms; {n_steps} steps, "
          f"{npix * n_steps / 1e6:.1f} M samples in {-(-npix // chunk)} "
          f"chunks of {chunk} rays ({tag})")
    expect_frame("march-rendered frame", march, state, img, dev, launches)
    pos, pw = splat.product_deposits(state.photons)
    on_frame, _ = check_on_list(
        f"the {pos.shape[0]} slots of the march-rendered frame", pos, pw,
        state.photons.radius_rel, step.light_volume_shape(config), 50, tag)

    # 1. The dense marcher against its loop twin.
    o, d = camera.rays(rc.width, rc.height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    pick = torch.from_numpy(np.random.default_rng(0).choice(
        npix, CHECK_RAYS, replace=False)).to(dev)
    dense = gather.render_rays(vol, tf, lv, o[pick], d[pick], n_steps,
                               rc.ambient)
    loop = gather.render_rays_loop(vol, tf, lv, o[pick], d[pick], n_steps,
                                   rc.ambient)
    dense_err = float((dense - loop).abs().max())
    chunked = float((dense - img.reshape(-1, 4)[pick]).abs().max())
    print(f"render_rays vs render_rays_loop on {CHECK_RAYS} pixels: "
          f"max_abs_err {dense_err:.3e} (max |loop| "
          f"{float(loop.abs().max()):.3e}; held to rtol {DENSE_RTOL}, atol "
          f"{DENSE_ATOL}); the frame's pixels, marched in chunks of {chunk}, "
          f"differ from them by {chunked:.3e}")
    torch.testing.assert_close(dense, loop, rtol=DENSE_RTOL, atol=DENSE_ATOL)

    # 2. The sweep's intermediate image against its oracle.
    _, inter, grid = sweep_render.sweep_render(vol, tf, lv, camera, rc,
                                               return_intermediate=True)
    axis, _ = sweep_render.principal_axis(camera)
    idx, o_r, d_r, za = intermediate_rays(camera, inter, grid, axis,
                                          CHECK_RAYS, dev)
    oracle = sweep_render.march_zplanes_oracle(vol, tf, lv, o_r, d_r, za,
                                               axis, rc.ambient)
    got = inter.reshape(-1, 4)[idx]
    oracle_err = float((got - oracle).abs().max())
    print(f"sweep intermediate ({inter.shape[1]}x{inter.shape[0]}, "
          f"{za.shape[0]} planes) vs march_zplanes_oracle on {CHECK_RAYS} "
          f"rays: max_abs_err {oracle_err:.3e} (max |oracle| "
          f"{float(oracle.abs().max()):.3e}; held to rtol {ORACLE_RTOL}, atol "
          f"{ORACLE_ATOL})")
    torch.testing.assert_close(got, oracle, rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL)
    del inter, dense, loop, oracle

    # 3. Both renderers in turns, and where they make the host wait.
    configs = {"march": march, "sweep": config}
    turns = [(m, cuda_ms(lambda m=m: step.render_state(scene, state,
                                                      configs[m]), reps=3))
             for m in ("march", "sweep", "sweep", "march")]
    waits = {m: sum(host_waits(lambda m=m: step.render_state(
        scene, state, configs[m])).values()) for m in configs}
    print("render_state in turns: " + ", ".join(
        f"{m} {t:.3f} ms" for m, t in turns) + f"; host waits per render "
        f"{waits} ({tag})")
    inside = eye_inside(scene, lv, dev, tag)
    del scene, state, img
    torch.cuda.empty_cache()
    return {"launches": launches, "on_frame": on_frame, "first_run_ms": ms,
            "n_steps": n_steps, "chunks": -(-npix // chunk),
            "dense_vs_loop_max_abs_err": dense_err,
            "oracle_max_abs_err": oracle_err, "in_turns": turns,
            "host_waits": waits, "eye_inside": inside}


def screen_weighted(scene, config, state, unweighted: dict, dev,
                    tag) -> dict:
    """``build_importance_grid(..., screen_space_weight=SCREEN_WEIGHT)``
    after the TF edit, at the default camera and at a NARROW_FOV one: the
    grid equals base x ((1 - w) + w x vis), nowhere above base. The weight
    never zeroes an importance, so the narrow camera's drain through
    ``step()`` (counted) retraces the photons the unweighted drain did, in
    another order, each under its own stream: photons equal to that
    drain's bit for bit (so the flagged ones to the full retrace's), the
    light volume within DRAINED_RTOL, ATOL_REL x its peak."""
    edited = edit_tf(scene)
    base = step.build_importance_grid(edited, config).data
    w = SCREEN_WEIGHT
    grids = {}
    for what, camera in (("default camera", scene.camera),
                         (f"{NARROW_FOV:g} degree camera",
                          Camera.create(fov_y=NARROW_FOV))):
        seen = dataclasses.replace(edited, camera=camera)
        grid = step.build_importance_grid(seen, config,
                                          screen_space_weight=w)
        mm = minmax.volume_min_max(seen.volume,
                                   config.recompute.grid_cell_size)
        vis = screen_importance.cell_visibility_from_camera(mm, seen.tf,
                                                            camera)
        torch.testing.assert_close(grid.data, base * ((1.0 - w) + w * vis),
                                   rtol=GRID_RTOL, atol=0.0)
        if bool((grid.data > base).any()):
            raise AssertionError(f"{what}: the weighted grid exceeds base")
        print(f"screen-weighted importance grid (w {w}), {what}: equals "
              f"base x ((1 - w) + w x vis) within rtol {GRID_RTOL}; "
              f"{int((grid.data < base).sum())} of {int((base > 0).sum())} "
              f"nonzero cells below base")
        grids[what] = (seen, grid)
    seen, grid = grids[f"{NARROW_FOV:g} degree camera"]
    n = state.photons.n
    budget = step.recompute_budget(config, n)
    r = f32_scalar(config.tracer.radius_rel)
    dim = step.light_volume_shape(config)
    design = sp.choose_design(2 * state.photons.max_interactions * budget, r,
                              dim)
    flagged = int((step.recompute_importance(
        config, grid, state.photons, state.light_samples) > 0.0).sum())
    reset_counts()
    (drained, first, batches), ms = timed_once(
        lambda: drain(seen, config, state, grid))
    launches = read_counts()
    print(f"screen-weighted drain ({NARROW_FOV:g} degree camera, first run): "
          f"{flagged} photons flagged, {batches} batches in {ms:.1f} ms, "
          f"launches {launches}; unweighted: {unweighted['flagged']} flagged, "
          f"{unweighted['batches']} batches ({tag})")
    if batches != -(-flagged // budget) or flagged != unweighted["flagged"]:
        raise AssertionError("the screen-weighted drain flagged other photons "
                             "or took another number of batches")
    expect_launches("screen-weighted drain", launches, [design] * batches)
    ref = unweighted["drained"]
    for f in PHOTON_FIELDS:
        if not torch.equal(getattr(drained.photons, f),
                           getattr(ref.photons, f)):
            raise AssertionError(f"the screen-weighted drain's {f} differ "
                                 "from the unweighted drain's")
    peak = float(ref.light_volume.abs().max())
    err = float((drained.light_volume - ref.light_volume).abs().max())
    print(f"screen-weighted drain vs the unweighted one: photons bit-equal, "
          f"light volume max_abs_err {err:.3e} (max |ref| {peak:.3e}); rel L1 "
          f"to the full retrace "
          f"{rel_l1(drained.light_volume, unweighted['full_edit'].light_volume):.3e}")
    torch.testing.assert_close(drained.light_volume, ref.light_volume,
                               rtol=DRAINED_RTOL, atol=ATOL_REL * peak)
    pos, pw = batch_deposits(state, first, config)
    on_delta, _ = check_on_list(
        f"the {pos.shape[0]} signed delta slots of a screen-weighted "
        "correlated step", pos, pw, r, dim, 50, tag)
    return {"launches": launches, "batches": batches, "flagged": flagged,
            "drain_ms": ms, "on_delta": on_delta}


def nee_mesh(scene, state, dev, tag) -> None:
    """At the default frame: ``nee_single_scatter`` of each light of
    OTHER_LIGHTS at the frame's deposit positions (finite, >= 0, and zero
    outside a cone's aperture), and the box mesh's spans of the frame's
    light samples against the slab test's."""
    pts = state.photons.positions[used_slots(state.photons)]
    for what, (light, _) in OTHER_LIGHTS.items():
        radiance, ms = timed_once(lambda: nee.nee_single_scatter(
            light, scene.volume, scene.tf, pts, key=rng.prng_key(5),
            n_steps=NEE_STEPS))
        if light.type == CONE:
            wi = nee.sample_light_toward(light, pts)[0]
            out_of_cone = (wi * torch.tensor(light.direction, device=dev)
                           ).sum(-1) < light.cos_fov
            outside = int(out_of_cone.sum())
            if bool((radiance[out_of_cone] != 0.0).any()):
                raise AssertionError("NEE of a cone light is not zero outside "
                                     "its aperture")
        print(f"NEE {what}: {pts.shape[0]} points, {NEE_STEPS} steps, "
              f"{ms:.2f} ms (first run); radiance max "
              f"{float(radiance.max()):.4g}, mean {float(radiance.mean()):.4g}"
              + (f", zero at the {outside} points outside the aperture"
                 if light.type == CONE else "") + f" ({tag})")
        if (radiance.shape != pts.shape or radiance.device != dev
                or not bool(torch.isfinite(radiance).all())
                or bool((radiance < 0.0).any())):
            raise AssertionError(f"NEE {what}: not finite and >= 0")
    ls = state.light_samples
    verts, faces = intersect.box_mesh()
    spans, ms = timed_once(lambda: intersect.light_sample_mesh_intersection(
        ls.origins, ls.directions, verts, faces))
    box = intersect.light_sample_box_intersection(ls.origins, ls.directions)
    f = faces.long()
    hits, _ = intersect.ray_triangles(ls.origins, ls.directions,
                                      verts[f[:, 0]], verts[f[:, 1]],
                                      verts[f[:, 2]])
    edge = hits.sum(-1) > 2
    hit_m, hit_b = spans[:, 1] >= spans[:, 0], box[:, 1] >= box[:, 0]
    agree = float((hit_m == hit_b).float().mean())
    both = hit_m & hit_b & ~edge
    err = float((spans[both] - box[both]).abs().max())
    print(f"mesh spans of {ls.n} light samples (box mesh, 12 triangles): "
          f"{ms:.2f} ms (first run); hit sets agree on {agree:.6f}, "
          f"{int(edge.sum())} rays through a mesh edge; spans where both hit "
          f"off the edges: {int(both.sum())}, max_abs_err {err:.3e} ({tag})")
    if (spans.device != dev or agree < 1.0 - MESH_EDGE_FRACTION
            or float(edge.float().mean()) > MESH_EDGE_FRACTION):
        raise AssertionError("the mesh and the slab test disagree on the hit "
                             "set")
    torch.testing.assert_close(spans[both], box[both], rtol=1e-4, atol=1e-5)


# --- trajectory gradients (replay, score surrogate, splat backward) -------

GRAD_TAPE = 64  # event-tape cap; the default frame's lanes make <= 48 tests
GRAD_REPLAY_RTOL = 2e-5  # replayed vs traced powers (tests/test_grad.py)
GRAD_LIGHT_RTOL = 1e-4  # light radiance: the loss is affine in it
GRAD_FD_RTOL = 5e-2  # finite differences, as tests/test_grad.py
GRAD_EULER_RTOL = 1e-5  # <P, dL/dP> = L - L(P = 0)
# The card's and the CPU's estimator: the card's backward gathers and
# atomics sum in another order.
GRAD_CPU_RTOL = 1e-3
GRAD_CHANNELS = (0.5, 1.0, 1.5)  # tests/test_grad.py:_loss's weights
FIT_REL_ERR = 0.2  # examples/fit_tf.py's exit rule
ADJOINT_RTOL = 1e-5
FIT_EXAMPLE = Path(__file__).resolve().parent / "examples" / "fit_tf_torch.py"


def grad_bound(pos, r: float, dim) -> dict:
    """The least time the card could take for the splat's backward: bytes
    (12 of position read and 12 of gradient written a slot, the grid's
    gradient read once) over the memory rate against the operations this
    data needs (6 per weight of a cell inside a support, 7 per nonzero
    term: one product of weights and three multiply-adds) over the fp32
    rate."""
    m = pos.shape[0]
    counts = splat_bound(pos, torch.zeros_like(pos), r, dim)
    byts = 24 * m + 12 * math.prod(dim)
    flop = 6 * counts["weights"] + 7 * counts["nonzero_terms"]
    by_bytes, by_ops = byts / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": byts, "flop": flop}


def check_backward(what: str, pos, pw, r: float, dim, seed: int,
                   tag) -> dict:
    """The backward kernel against its plain version on one deposit list
    with a seeded grid gradient (rtol 1e-4, atol 1e-6 of the largest
    value), the adjoint identity <splat(P), G> = <P, splat^T(G)>, and its
    device time beside the bound, the plain version's and the bare
    kernel's (event-timed through the C entry point)."""
    rs = np.random.default_rng(seed)
    g = torch.from_numpy(rs.standard_normal((*dim, 3)).astype(np.float32)
                         ).to(pos.device)
    got = sp.splat_product_grad(pos, g, r, dim)
    torch.cuda.synchronize()
    ref = sp.splat_product_grad_torch(pos, g, r, dim)
    err = compare(got, ref, f"splat backward kernel vs plain on {what}")
    if bool((got[pos[:, 0] >= 1e30] != 0.0).any()):
        raise AssertionError(f"{what}: an unused slot got a gradient")
    fwd = sp.splat_product(pos, pw, r, dim)
    lhs = float((fwd.double() * g.double()).sum())
    rhs = float((pw.double() * got.double()).sum())
    adjoint = abs(lhs - rhs) / abs(lhs)
    print(f"adjoint identity on {what}: <splat(P), G> {lhs:.9e}, "
          f"<P, splat^T(G)> {rhs:.9e}, relative difference {adjoint:.3e} "
          f"(held to {ADJOINT_RTOL})")
    if adjoint > ADJOINT_RTOL:
        raise AssertionError(f"{what}: the backward is not the forward's "
                             "adjoint")
    lib = sp._library()
    out = torch.empty_like(pw)
    inv_r = float(sp.inverse_radius(r))
    width = sp.kernel_width(r, dim)
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        if lib.cpm_splat_grad(pos.data_ptr(), g.data_ptr(), pos.shape[0], r,
                              inv_r, *dim, width, out.data_ptr(), stream):
            raise RuntimeError("splat backward kernel failed")

    runs = [device_ms("grad", lambda: sp.splat_product_grad(pos, g, r, dim),
                      50) for _ in range(2)]
    if min(runs) == 0.0:
        raise AssertionError("torch.profiler showed no device time")
    bound = grad_bound(pos, r, dim)
    res = {"deposits": pos.shape[0], "live": int((pos[:, 0] < 1e30).sum()),
           "max_abs_err": err, "adjoint_rel": adjoint, "ms_runs": runs,
           "ms": statistics.median(runs), "bare_ms": cuda_ms(bare, 200),
           "wrapper_ms": cuda_ms(
               lambda: sp.splat_product_grad(pos, g, r, dim), 200),
           "plain_ms": cuda_ms(
               lambda: sp.splat_product_grad_torch(pos, g, r, dim), 3),
           **bound, "library_ms": None}
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    print(f"splat backward on {what}: {res['deposits']} slots "
          f"({res['live']} live) -> {dim}: device "
          + ", ".join(f"{t:.4f}" for t in runs)
          + f" ms, bare {res['bare_ms']:.4f} ms, wrapper "
          f"{res['wrapper_ms']:.4f} ms, plain {res['plain_ms']:.3f} ms; "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}: "
          f"{res['bytes']} B, {res['flop']} flop), "
          f"{100 * res['share_of_bound']:.1f}% of it ({tag})")
    return res


def image_loss(scene, config, photons, samples, dim):
    """tests/test_grad.py:_loss at the frame: the channel-weighted sum of
    the sweep image (float64 sum) of the splatted replay, a function of
    (volume data, TF colours, per-channel light scale)."""
    w = torch.tensor(GRAD_CHANNELS, dtype=torch.float64,
                     device=photons.positions.device)

    def loss(vol_data, tf_colors, light_scale):
        vol = dataclasses.replace(scene.volume, data=vol_data)
        tf = TransferFunction.from_points(scene.tf.positions, tf_colors,
                                          device=vol_data.device)
        ls = dataclasses.replace(samples,
                                 powers=samples.powers * light_scale)
        ph = replay.replay_photons(vol, tf, scene.tf_scattering, photons, ls)
        lv = splat.splat_all(ph, dim, method="auto")
        img = sweep_render.sweep_render(vol, tf, lv, scene.camera,
                                        config.render)
        return (img[..., :3].double() * w).sum()

    return loss


def deposit_loss(scene, config, dim, photons, target=None):
    """A loss of the (I, N, 3) deposits for ``score_grad``: the
    channel-weighted image sum, or, given a target image, the image MSE
    (x 1e3, as examples/fit_tf.py) taking the render's TF from the
    scene."""
    def render(dep, tf):
        lv = splat.splat_all(dataclasses.replace(photons, powers=dep), dim,
                             method="auto")
        return sweep_render.sweep_render(scene.volume, tf, lv, scene.camera,
                                         config.render)

    if target is None:
        w = torch.tensor(GRAD_CHANNELS, dtype=torch.float64,
                         device=scene.device)
        return lambda dep: (render(dep, scene.tf)[..., :3].double()
                            * w).sum()
    return lambda dep, vol, tf, tfs, ls: (
        (render(dep, tf)[..., :3] - target[..., :3]) ** 2).mean() * 1e3


def mse_tf_gradient(scene, config, samples, photons, events, target, dim):
    """The full (pathwise + score) estimator of the image MSE's gradient
    with respect to the TF colours: (the MSE at the traced powers,
    gradient (P, 4))."""
    loss = deposit_loss(scene, config, dim, photons, target)
    with torch.no_grad():
        mse = float(loss(photons.powers, scene.volume, scene.tf,
                         scene.tf_scattering, samples))
    sur = score_grad.make_surrogate(scene.volume, scene.tf,
                                    scene.tf_scattering, samples, photons,
                                    events, loss, loss_takes_scene=True)
    colors = scene.tf.colors.detach().clone().requires_grad_(True)
    tf = TransferFunction.from_points(scene.tf.positions, colors,
                                      device=colors.device)
    g, = torch.autograd.grad(
        sur(scene.volume, tf, scene.tf_scattering, samples), colors)
    return mse, g


def to_device(obj, device):
    """A container of the port (a dataclass or named tuple of tensors and
    numbers) with every tensor moved."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    return dataclasses.replace(obj, **{
        f.name: to_device(getattr(obj, f.name), device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def run_fit(tag) -> dict:
    """examples/fit_tf_torch.py's main() on the card, counted."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("fit_tf_torch",
                                                  FIT_EXAMPLE)
    fit = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = fit
    spec.loader.exec_module(fit)
    reset_counts()
    t0 = time.perf_counter()
    err = fit.main([])
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = {**read_counts(),
                "splat_product_grad_cuda": sp.splat_product_grad_cuda.launches}
    print(f"fit_tf_torch on the card: {fit.N_STEPS} steps in {s:.2f} s, "
          f"relative error {err:.4f} (held to {FIT_REL_ERR}); launches "
          f"{launches} ({tag})")
    if not err < FIT_REL_ERR:
        raise AssertionError(f"fit_tf_torch missed theta by {err:.1%}")
    if launches["splat_product_grad_cuda"] < fit.N_STEPS:
        raise AssertionError("the fit did not run the backward kernel")
    if min(launches["sweep_planes"], launches["sweep_scan_forward"],
           launches["sweep_scan_backward"],
           launches["sweep_fold"]) < fit.N_STEPS:
        raise AssertionError("the fit did not render through the sweep "
                             "kernels, forward and backward")
    return {"steps": fit.N_STEPS, "seconds": s, "rel_err": err,
            "launches": launches}


def profile_gradient(fn, tag) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, the
    device's busy time (the sum of kernel and memory records), and the
    device operations that took most of it, by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    n_ops = 0
    for e in prof.events():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0.0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += t / 1e3
            n_ops += 1
    busy = sum(by_name.values())
    top = [(name, round(ms, 3)) for name, ms in by_name.most_common(8)]
    print(f"one trajectory_gradients under the profiler: wall {wall:.1f} ms, "
          f"{n_ops} device operations busy {busy:.1f} ms (idle "
          f"{100 * (1 - busy / wall):.1f}%); most device time: {top} "
          f"({tag})")
    return {"wall_ms": wall, "device_ops": n_ops, "busy_ms": busy,
            "top": top}


def gradients_default(delta_list, dev, tag) -> dict:
    """The gradient path at the default frame, through the port's entry
    points: the traced tape, the replay, a linear image loss's gradients
    against exact and finite differences and the Euler identity, the
    image MSE's full estimator against the CPU's, the backward kernel on
    the frame's list and a correlated step's delta list, times, launches
    and peak memory; then the fit."""
    t_phase = time.perf_counter()
    scene, config = build_frame()
    state = step.init_state(scene, config)
    samples = state.light_samples
    key = rng.fold_in(state.key, 0)
    dim = step.light_volume_shape(config)
    r = f32_scalar(config.tracer.radius_rel)

    def trace(cap):
        return tracer.trace_photons(
            scene.volume, scene.tf, scene.tf_scattering, samples, key,
            config.tracer, record_events=cap)

    # 1. The tape: photons equal to the trace without it, no lane over the
    # cap, no added host wait.
    plain = trace(0)
    (photons, events), tape_ms = timed_once(lambda: trace(GRAD_TAPE))
    for f in PHOTON_FIELDS:
        if not torch.equal(getattr(photons, f), getattr(plain, f)):
            raise AssertionError(f"the event tape changed the {f}")
    counts = events.counts
    most = int(counts.max())
    over = int((counts > GRAD_TAPE).sum())
    waits = {cap: sum(host_waits(lambda cap=cap: trace(cap)).values())
             for cap in (0, GRAD_TAPE)}
    turns = [(cap, cuda_ms(lambda cap=cap: trace(cap), reps=1, warmup=0))
             for cap in (0, GRAD_TAPE, GRAD_TAPE, 0)]
    tape_bytes = sum(t.numel() * t.element_size() for t in events)
    kinds = torch.bincount(events.types.reshape(-1)[
        (torch.arange(GRAD_TAPE, device=dev)[None, :]
         < counts[:, None]).reshape(-1)].long(), minlength=5).tolist()
    print(f"event tape of the default frame: {GRAD_TAPE} slots a lane, "
          f"most tests of a lane {most}, {over} lanes over the cap, "
          f"{int(counts.sum())} tests (null, scatter, absorb, forced, "
          f"first: {kinds}); {tape_bytes} B; host waits without / with "
          f"the tape {waits[0]} / {waits[GRAD_TAPE]}; trace in turns "
          + ", ".join(f"{'with' if cap else 'without'} {t:.3f} ms"
                      for cap, t in turns) + f" ({tag})")
    if over or most > GRAD_TAPE:
        raise AssertionError(f"{over} lanes overflow the event tape")
    if waits[GRAD_TAPE] != waits[0]:
        raise AssertionError("the event tape changes the host waits")
    del plain

    # 2. The replay equals the traced powers on the deposited slots.
    rp = replay.replay_powers(scene.volume, scene.tf, scene.tf_scattering,
                              photons, samples)
    dep = photons.positions[..., 0] < 1e30
    torch.testing.assert_close(rp[dep], photons.powers[dep],
                               rtol=GRAD_REPLAY_RTOL, atol=1e-8)
    if bool((rp[~dep] != 0.0).any()):
        raise AssertionError("the replay deposits in unused slots")
    err = float(((rp - photons.powers).abs()
                 / photons.powers.abs().clamp(min=1e-30))[dep].max())
    print(f"replay of {int(dep.sum())} deposits: max relative error to the "
          f"traced powers {err:.3e} (held to {GRAD_REPLAY_RTOL}), 0 on the "
          f"{int((~dep).sum())} unused slots")
    del rp

    # 3. The linear image loss: its gradients against an exact difference
    # (light scale), finite differences (density, TF colours) and, for the
    # full estimator, the Euler identity in the light powers.
    loss = image_loss(scene, config, photons, samples, dim)
    base = [scene.volume.data, scene.tf.colors,
            torch.ones(3, device=dev)]
    xs = [t.detach().clone().requires_grad_(True) for t in base]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    value = loss(*xs)
    grads = torch.autograd.grad(value, xs)
    torch.cuda.synchronize()
    lin_launches = {**read_counts(), "splat_product_grad_cuda":
                    sp.splat_product_grad_cuda.launches}
    lin_peak = torch.cuda.max_memory_allocated()
    value = float(value.detach())

    def at(i, delta):
        args = list(base)
        args[i] = args[i] + delta
        with torch.no_grad():
            return float(loss(*args))

    light = []
    for c in range(3):
        e = torch.zeros(3, device=dev)
        e[c] = 0.5
        exact = (at(2, e) - value) / 0.5
        light.append((exact, float(grads[2][c])))
        if not math.isclose(exact, light[-1][1], rel_tol=GRAD_LIGHT_RTOL):
            raise AssertionError(f"light channel {c}: gradient "
                                 f"{light[-1][1]} against {exact}")
    rs = np.random.default_rng(20)
    # Density: a positive direction on the 16^3 block at the cloud's centre,
    # so each voxel moves by ~eps / 64 as in tests/test_grad.py's 16^3 test.
    v_vol = torch.zeros_like(base[0])
    lo = [n // 2 - 8 for n in v_vol.shape]
    block = rs.random((16, 16, 16)).astype(np.float32) * 0.5 + 0.1
    v_vol[lo[0]:lo[0] + 16, lo[1]:lo[1] + 16, lo[2]:lo[2] + 16] = (
        torch.from_numpy(block).to(dev))
    v_tf = torch.from_numpy(rs.random(tuple(base[1].shape)).astype(
        np.float32) * 0.5 + 0.1).to(dev)
    fd = {}
    for name, i, v, eps in (("density", 0, v_vol, 3e-3),
                            ("TF colours", 1, v_tf, 2e-3)):
        v = v / torch.linalg.vector_norm(v)
        num = (at(i, eps * v) - at(i, -eps * v)) / (2 * eps)
        an = float((grads[i].double() * v.double()).sum())
        fd[name] = (num, an)
        if abs(an) < 1e-8 or not math.isclose(num, an,
                                              rel_tol=GRAD_FD_RTOL):
            raise AssertionError(f"{name}: gradient {an} against the finite "
                                 f"difference {num}")
    print(f"linear image loss {value:.9e} at 512^2: light-scale gradient vs "
          "exact difference " + ", ".join(f"{a:.7e} / {b:.7e}"
                                          for b, a in light)
          + "; finite differences (numeric / analytic): "
          + ", ".join(f"{k} {a:.6e} / {b:.6e}" for k, (a, b) in fd.items())
          + f"; one gradient launched {lin_launches}, peak "
          f"{lin_peak / 2**30:.2f} GiB ({tag})")
    if (lin_launches["sweep_planes"], lin_launches["sweep_scan_forward"],
            lin_launches["sweep_scan_backward"],
            lin_launches["sweep_fold"]) != (2, 1, 1, 1):
        raise AssertionError("the linear loss's gradient did not render "
                             "through the sweep kernels once each way")
    del grads, xs

    lin = deposit_loss(scene, config, dim, photons)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    (val, g), grad_ms = timed_once(
        lambda: score_grad.trajectory_gradients(
            scene.volume, scene.tf, scene.tf_scattering, samples, photons,
            events, lin))
    full_launches = {**read_counts(), "splat_product_grad_cuda":
                     sp.splat_product_grad_cuda.launches}
    full_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        dark = float(lin(torch.zeros_like(photons.powers)))
    euler = float((g["light_samples.powers"].double()
                   * samples.powers.double()).sum())
    rel = abs(euler - (float(val) - dark)) / abs(float(val) - dark)
    print(f"full estimator of the linear loss: {grad_ms:.1f} ms (first "
          f"run), launches {full_launches}, peak "
          f"{full_peak / 2**30:.2f} GiB; Euler identity <P, dL/dP> "
          f"{euler:.9e} against L - L(P = 0) {float(val) - dark:.9e} "
          f"(L(P = 0) = {dark:.6e}, the ambient term): relative "
          f"{rel:.3e} (held to {GRAD_EULER_RTOL}) ({tag})")
    if rel > GRAD_EULER_RTOL:
        raise AssertionError("the Euler identity fails")
    if full_launches["splat_product_grad_cuda"] < 1 or full_launches[
            "splat_product_direct"] < 1:
        raise AssertionError("the gradient did not run both splat kernels")
    if min(full_launches["sweep_planes"], full_launches["sweep_scan_forward"],
           full_launches["sweep_scan_backward"],
           full_launches["sweep_fold"]) < 1:
        raise AssertionError("the gradient did not run the sweep kernels")
    del g

    # 4. The image MSE against a target after the TF edit: the full
    # estimator with respect to the TF colours on the card and on the CPU
    # from the same photons and tape.
    _, target = run_frame(edit_tf(scene), config)
    mse, g_card = mse_tf_gradient(scene, config, samples, photons, events,
                                  target, dim)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu_scene = dataclasses.replace(scene, **{
        f: to_device(getattr(scene, f), cpu)
        for f in ("volume", "tf", "tf_scattering", "camera")})
    mse_cpu, g_cpu = mse_tf_gradient(
        cpu_scene, config, to_device(samples, cpu),
        to_device(photons, cpu), to_device(events, cpu), target.cpu(), dim)
    cpu_s = time.perf_counter() - t0
    print(f"image MSE after the TF edit: {mse:.9e} (CPU {mse_cpu:.9e}); "
          f"TF-colour gradient of the full estimator, card vs CPU: max "
          f"relative difference "
          f"{float(((g_card.cpu() - g_cpu).abs() / g_cpu.abs().max()).max()):.3e} "
          f"of the largest component (held to rtol {GRAD_CPU_RTOL}); the "
          f"CPU's took {cpu_s:.1f} s ({tag})")
    torch.testing.assert_close(g_card.cpu(), g_cpu, rtol=GRAD_CPU_RTOL,
                               atol=GRAD_CPU_RTOL * float(
                                   g_cpu.abs().max()))
    if not math.isclose(mse, mse_cpu, rel_tol=GRAD_CPU_RTOL):
        raise AssertionError("the MSE differs between card and CPU")

    # 5. Times of the gradient's stages (warm, CUDA events).
    mse_loss = deposit_loss(scene, config, dim, photons, target)
    sur = score_grad.make_surrogate(scene.volume, scene.tf,
                                    scene.tf_scattering, samples, photons,
                                    events, mse_loss, loss_takes_scene=True)
    colors = scene.tf.colors.detach().clone().requires_grad_(True)

    def forward():
        return sur(scene.volume, TransferFunction.from_points(
            scene.tf.positions, colors, device=dev), scene.tf_scattering,
                   samples)

    def backward():
        return torch.autograd.grad(forward(), colors)

    stages = {
        "trace with the tape": lambda: trace(GRAD_TAPE),
        "replay_powers": lambda: replay.replay_powers(
            scene.volume, scene.tf, scene.tf_scattering, photons, samples),
        "log_prob_lanes": lambda: score_grad.log_prob_lanes(
            events, scene.volume, scene.tf, scene.tf_scattering),
        "make_surrogate (MSE)": lambda: score_grad.make_surrogate(
            scene.volume, scene.tf, scene.tf_scattering, samples, photons,
            events, mse_loss, loss_takes_scene=True),
        "surrogate forward": forward,
        "surrogate forward + backward": backward,
        "trajectory_gradients (linear loss)":
            lambda: score_grad.trajectory_gradients(
                scene.volume, scene.tf, scene.tf_scattering, samples,
                photons, events, lin),
    }
    # Every stage has run before: warm, two repetitions each.
    times = {name: cuda_ms(fn, reps=2, warmup=0)
             for name, fn in stages.items()}
    for name, t in times.items():
        print(f"gradient stage {name}: {t:.3f} ms ({tag})")

    busy = profile_gradient(stages["trajectory_gradients (linear loss)"],
                            tag)

    # 6. The backward kernel on the frame's own deposit list and on a
    # correlated step's signed delta list.
    pos, pw = splat.product_deposits(photons)
    on_frame = check_backward("the default frame's deposits", pos, pw, r,
                              dim, 30, tag)
    on_delta = check_backward(
        f"the {delta_list[0].shape[0]} signed delta slots of a default "
        "correlated step", *delta_list, r, dim, 31, tag)
    del scene, state, photons, events, sur, target, stages
    torch.cuda.empty_cache()
    fitted = run_fit(tag)
    print(f"the gradients phase and the fit took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"tape": {"cap": GRAD_TAPE, "most": most, "over": over,
                     "bytes": tape_bytes, "host_waits": waits,
                     "trace_ms_in_turns": turns, "first_run_ms": tape_ms,
                     "types": kinds},
            "light": light, "finite_differences": fd, "euler_rel": rel,
            "linear_launches": lin_launches, "launches": full_launches,
            "peak_bytes": {"linear_gradient": lin_peak,
                           "trajectory_gradients": full_peak},
            "whole_gradient_first_run_ms": grad_ms, "stage_ms": times,
            "profile": busy,
            "mse_card_vs_cpu": [mse, mse_cpu], "cpu_s": cpu_s,
            "on_frame": on_frame, "on_delta": on_delta, "fit": fitted}


# --- multi-device (sharding, multihost) and the config 1 demo ------------

# A sharded frame against the single-device one from the same state: the
# photons bit for bit, the light volume and the image within the order of
# the float32 sums (the ranks' partial grids, the kernel's atomics).
WORLD_RTOL = 1e-5
WORLD_ATOL_REL = 1e-6
WORLD_METHODS = ("sweep", "march")
WORLD_TIMEOUT_S = 300.0
DEMO_EXAMPLE = (Path(__file__).resolve().parent / "examples"
                / "render_sphere_torch.py")
DEMO_MIN_DEPOSITS = 10_000  # "tens of thousands of deposited interactions"


def lanes_differing(got: dict, want, lanes: slice) -> int:
    """The lanes of ``lanes`` whose photon fields in ``got`` (CPU tensors)
    differ from ``want``'s in any bit."""
    same = None
    for f in PHOTON_FIELDS:
        w = getattr(want, f).cpu()
        w = w[:, lanes] if w.dim() == 3 else w[lanes]
        eq = got[f] == w
        eq = eq.all(2).all(0) if eq.dim() == 3 else (
            eq.all(1) if eq.dim() == 2 else eq)
        same = eq if same is None else same & eq
    return int((~same).sum())


def expect_sharded(what: str, ranks: list, single_state, single_img) -> dict:
    """Hold a world's frame (each rank's {"photons", "light_volume",
    "image"}, in rank order) against the single-device one: every rank's
    photons equal the single trace's lanes of its slice bit for bit; every
    rank's light volume and image within WORLD_RTOL, WORLD_ATOL_REL of the
    peak. Returns the largest errors."""
    n = single_state.photons.n
    per = n // len(ranks)
    differ = sum(lanes_differing(out["photons"], single_state.photons,
                                 slice(r * per, (r + 1) * per))
                 for r, out in enumerate(ranks))
    errs = {"lanes_differing": differ, "light_volume": 0.0, "image": 0.0}
    for out in ranks:
        for key, want in (("light_volume", single_state.light_volume),
                          ("image", single_img)):
            want = want.cpu()
            got = out[key].cpu()
            scale = float(want.abs().max())
            torch.testing.assert_close(
                got, want, rtol=WORLD_RTOL, atol=WORLD_ATOL_REL * scale,
                msg=lambda m: f"{what}: {key}: {m}")
            errs[key] = max(errs[key], float((got - want).abs().max()))
    print(f"{what}: {differ} of {n} lanes differ from the single-device "
          f"trace; light volume max_abs_err {errs['light_volume']:.3e}, "
          f"image max_abs_err {errs['image']:.3e} (rtol {WORLD_RTOL}, atol "
          f"{WORLD_ATOL_REL} of the peak)")
    if differ:
        raise AssertionError(f"{what}: {differ} lanes differ from the "
                             "single-device trace")
    return errs


def single_device_frames() -> tuple:
    """The default frame's scene, config and initial state, and for each
    render method the single-device frame from that state:
    {method: (state, image)}."""
    scene, config = build_frame()
    state0 = step.init_state(scene, config)
    single = {}
    for m in WORLD_METHODS:
        cfg = with_render(config, method=m)
        st = step.full_trace_step(scene, state0, cfg)
        single[m] = (st, step.render_state(scene, st, cfg))
    return scene, config, state0, single


def world_of_one(scene, config, state0, single, tag) -> dict:
    """A world of 1 on NCCL in this process: ``sharded_full_step`` for each
    render method, counted, against the single-device frame."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(mh.free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        mh.initialize_distributed("nccl")
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = psh.make_mesh()
        state = dataclasses.replace(state0, light_samples=(
            psh.shard_light_samples(state0.light_samples, mesh)))
        for m in WORLD_METHODS:
            cfg = with_render(config, method=m)
            reset_counts()
            t0 = time.perf_counter()
            new, img = psh.sharded_full_step(scene, state, cfg, mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts()
            slots = new.photons.positions.shape[0] * new.photons.n
            expect_launches(f"world of 1 (nccl), {m}", launches, [
                sp.choose_design(slots, new.photons.radius_rel,
                                 step.light_volume_shape(cfg))],
                sweeps=int(m == "sweep"))
            errs = expect_sharded(
                f"world of 1 (nccl), {m}",
                [{"photons": {f: getattr(new.photons, f).cpu()
                              for f in PHOTON_FIELDS},
                  "light_volume": new.light_volume, "image": img}],
                *single[m])
            # Warm, in turns with the single-device frame from the same
            # state (CUDA events around each whole call).
            def single_frame(cfg=cfg):
                st = step.full_trace_step(scene, state0, cfg)
                return step.render_state(scene, st, cfg)

            turns = {"single": [], "sharded": []}
            for name in ("single", "sharded", "sharded", "single"):
                fn = single_frame if name == "single" else (
                    lambda cfg=cfg: psh.sharded_full_step(scene, state, cfg,
                                                          mesh))
                turns[name].append(cuda_ms(fn, reps=1, warmup=0))
            print(f"world of 1 (nccl), {m}: sharded_full_step first run "
                  f"{ms:.1f} ms, launches {launches}; in turns: "
                  + ", ".join(f"{k} " + " / ".join(f"{t:.1f}" for t in v)
                              for k, v in turns.items())
                  + f" ms ({tag})")
            out[m] = {"first_run_ms": ms, "launches": launches,
                      "in_turns_ms": turns, **errs}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def world_rank(rank: int, n_hosts: int, methods: tuple,
               out_dir: str) -> None:
    """One rank of a gloo world on the card (every rank on the current
    card): the default frame from the converted initial state in
    ``out_dir``, sharded over the world (``n_hosts`` > 0: a (hosts, chips)
    mesh), one counted full step per render method, then each stage's
    time; prints its line and saves its results in ``out_dir``."""
    world = dist.get_world_size()
    scene, config = build_frame()
    state = convert.state_from_numpy(
        dict(np.load(os.path.join(out_dir, "state.npz"))),
        device=scene.device)
    if n_hosts:
        mesh = mh.make_hosts_chips_mesh(n_hosts)
        flat, groups = mesh.flat, (mesh.chips_group, mesh.hosts_group)
        shard, full = mh.shard_light_samples_2d, mh.multihost_full_step
    else:
        mesh = flat = psh.make_mesh()
        groups = (mesh.group,)
        shard, full = psh.shard_light_samples, psh.sharded_full_step
    state = dataclasses.replace(state, light_samples=shard(
        state.light_samples, mesh))
    out = {"rank": rank, "device": str(scene.device)}
    for m in methods:
        cfg = with_render(config, method=m)
        full(scene, state, cfg, mesh)  # warm: loads the kernel library
        reset_counts()
        new, img = full(scene, state, cfg, mesh)
        torch.cuda.synchronize()
        out[m] = {"launches": read_counts(),
                  "photons": {f: getattr(new.photons, f).cpu()
                              for f in PHOTON_FIELDS},
                  "light_volume": new.light_volume.cpu(),
                  "image": img.cpu()}
    per = state.light_samples.n
    slots = new.photons.positions.shape[0] * per
    dim = step.light_volume_shape(config)
    out["slots"] = slots
    out["design"] = sp.choose_design(slots, new.photons.radius_rel, dim)
    key = rng.fold_in(state.key, 0)
    lane_ids = flat.rank * per + torch.arange(per, dtype=torch.int64,
                                              device=scene.device)
    lv = new.light_volume
    buf = lv.clone()
    rcfg = config.render
    origins, dirs = scene.camera.rays(rcfg.width, rcfg.height)
    n_steps = gather.default_steps(scene.volume, rcfg.sampling_rate)
    stages = {
        "trace": lambda: tracer.trace_photons(
            scene.volume, scene.tf, scene.tf_scattering,
            state.light_samples, key, config.tracer, lane_ids=lane_ids),
        "splat": lambda: splat.splat_all(
            new.photons, dim, step.splat_footprint(config),
            n_total=per * world, method="cuda"),
        "all_reduce": lambda: [dist.all_reduce(buf, group=g)
                               for g in groups],
        "render sweep": lambda: psh.sharded_sweep_render(
            scene.volume, scene.tf, lv, scene.camera, rcfg, flat),
        "render march": lambda: psh.sharded_render_rays(
            scene.volume, scene.tf, lv, origins.reshape(-1, 3),
            dirs.reshape(-1, 3), n_steps, rcfg.ambient, flat),
    }
    for m in methods:
        cfg = with_render(config, method=m)
        stages[f"step {m}"] = lambda cfg=cfg: full(scene, state, cfg, mesh)
    out["stage_ms"] = {name: cuda_ms(fn, reps=2)
                       for name, fn in stages.items()
                       if not name.startswith("render ")
                       or name.split()[1] in methods}
    shape = (f"{mesh.n_hosts} hosts x {mesh.n_chips} chips" if n_hosts
             else f"{world} ranks")
    print(f"rank {rank} of {world} ({shape}, gloo, {scene.device}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out["stage_ms"].items())
          + f"; {slots} deposit slots, design {out['design']}, launches "
          + "; ".join(f"{m} {out[m]['launches']}" for m in methods)
          + " (CUDA events; the ranks share the card and the host)",
          flush=True)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def gloo_world(what: str, world: int, n_hosts: int, methods: tuple,
               state0, single, tag) -> dict:
    """A gloo world of ``world`` processes on the card (``n_hosts`` > 0: as
    n_hosts x chips), every rank from the same converted state: each
    method's frame held against the single-device one, and each rank's
    splat launched once, in the design the wrapper names."""
    with tempfile.TemporaryDirectory() as out_dir:
        # The state goes by file: a spawned rank's arguments stay small.
        np.savez(os.path.join(out_dir, "state.npz"),
                 **convert.state_to_numpy(state0))
        t0 = time.perf_counter()
        mh.launch_local_world(world_rank, world, "gloo",
                              (n_hosts, methods, out_dir),
                              timeout_s=WORLD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
                 for r in range(world)]
    res = {"world": world, "wall_s": wall, "errors": {},
           "slots": ranks[0]["slots"], "design": ranks[0]["design"],
           "launches": ranks[0][methods[0]]["launches"],
           "launches_per_rank": {m: [r[m]["launches"] for r in ranks]
                                 for m in methods},
           "stage_ms_per_rank": [r["stage_ms"] for r in ranks]}
    for m in methods:
        res["errors"][m] = expect_sharded(f"{what}, {m}",
                                          [r[m] for r in ranks], *single[m])
        for r in ranks:
            expect_launches(f"{what}, {m}, rank {r['rank']}",
                            r[m]["launches"], [r["design"]],
                            sweeps=int(m == "sweep"))
    print(f"{what}: {world} processes in {wall:.1f} s, ranks on "
          f"{sorted({r['device'] for r in ranks})} ({tag})")
    return res


def shard_on_kernel(what: str, photons, world: int, dim, tag) -> dict:
    """Rank 0's shard of a ``world``-rank frame (the single trace's first
    lanes, which the world traced bit for bit): ``splat_all(n_total=)``
    through the kernel against the plain path, then both designs and the
    plain version on its deposit list, timed beside the bound."""
    n = photons.n
    per = n // world
    shard = dataclasses.replace(
        photons, **{f: (getattr(photons, f)[:, :per]
                        if getattr(photons, f).dim() == 3
                        else getattr(photons, f)[:per]).contiguous()
                    for f in PHOTON_FIELDS})
    compare(splat.splat_all(shard, dim, n_total=n, method="cuda"),
            splat.splat_all(shard, dim, n_total=n, method="matmul"),
            f"{what}: splat_all(n_total={n}) kernel vs plain")
    pos, pw = splat.product_deposits(shard, n_total=n)
    res, _ = check_on_list(what, pos, pw, photons.radius_rel, dim, 20, tag)
    return res


def multi_device(dev, tag) -> dict:
    """Phases a-c: the default frame over a world of 1 on NCCL, 2 gloo
    ranks (sweep and marcher) and 2 x 2 gloo ranks (sweep), all on this
    card, each against the single-device frame; the kernel on one rank's
    shard of 2 and of 4."""
    t0 = time.perf_counter()
    scene, config, state0, single = single_device_frames()
    res = {"world1_nccl": world_of_one(scene, config, state0, single, tag)}
    res["world2"] = gloo_world("2 gloo ranks on one card", 2, 0,
                               WORLD_METHODS, state0, single, tag)
    res["world4"] = gloo_world("2 hosts x 2 chips, gloo, on one card", 4, 2,
                               ("sweep",), state0, single, tag)
    photons = single["sweep"][0].photons
    dim = step.light_volume_shape(config)
    for key, world in (("world2", 2), ("world4", 4)):
        res[key]["on_shard"] = shard_on_kernel(
            f"one rank's shard of {world}", photons, world, dim, tag)
    print(f"the multi-device phase took {time.perf_counter() - t0:.1f} s")
    return res


def demo_config1(dev, tag) -> dict:
    """Phase d: examples/render_sphere_torch.py's body (BASELINE config 1)
    on the card, counted, with its printed lines: the kernel against the
    plain version on the demo's own deposits, alpha max 1, tens of
    thousands of deposits."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("render_sphere_torch",
                                                  DEMO_EXAMPLE)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    reset_counts()
    t0 = time.perf_counter()
    out = demo.render_sphere()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    photons, lv, img = out["photons"], out["light_volume"], out["image"]
    dim = tuple(lv.shape[:3])
    slots = photons.positions.shape[0] * photons.n
    design = sp.choose_design(slots, photons.radius_rel, dim)
    expect_launches("the config 1 demo", launches, [design, design],
                    sweeps=2)
    deposited = int((photons.positions[..., 0] < 1e30).sum())
    alpha = float(img[..., 3].max())
    print(f"config 1 demo on the card: two runs in {wall:.2f} s, {deposited} "
          f"deposits of {slots} slots, image alpha max {alpha:.6f}, "
          f"launches {launches} ({tag})")
    if img.device != dev or lv.device != dev:
        raise AssertionError("the config 1 demo left the card")
    if deposited < DEMO_MIN_DEPOSITS:
        raise AssertionError(f"the config 1 demo deposited {deposited}")
    if abs(alpha - 1.0) > 1e-5 or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the config 1 demo's alpha max is {alpha}")
    pos, pw = splat.product_deposits(photons)
    on_list, ref = check_on_list("the config 1 demo's deposits", pos, pw,
                                 photons.radius_rel, dim, 20, tag)
    compare(lv, ref, "config 1 demo: light volume (kernel) vs plain splat")
    # The shape of the demo's trace (its scene, samples and key, as
    # render_sphere builds them): flights and the mean active fraction.
    volume = Volume.from_data(synthetic.sphere_in_box(64))
    tf = TransferFunction.from_points(*synthetic.default_tf_points())
    tfs = TransferFunction.from_points(*synthetic.default_scattering_points())
    cfg = TracerConfig(max_interactions=4)
    again, stats = tracer.trace_photons(volume, tf, tfs, out["light_samples"],
                                        rng.prng_key(7), cfg,
                                        return_stats=True)
    if not torch.equal(again.positions, photons.positions):
        raise AssertionError("the demo's trace is not reproduced")
    trace_ms = cuda_ms(lambda: tracer.trace_photons(
        volume, tf, tfs, out["light_samples"], rng.prng_key(7), cfg), reps=3)
    demo_stats = {"flights": stats["wavefront_iters"],
                  "mean_active_frac": float(stats["mean_active_frac"]),
                  "trace_ms": trace_ms}
    print(f"config 1 demo's trace: {demo_stats['flights']} flights, mean "
          f"active fraction {demo_stats['mean_active_frac']:.6f}, "
          f"{trace_ms:.3f} ms ({tag})")
    return {"on_list": on_list, "launches": launches, "wall_s": wall,
            "first_ms": out["first_ms"], "steady_ms": out["steady_ms"],
            "deposited": deposited, "alpha_max": alpha,
            "trace_stats": demo_stats}


def kernel_rows(shapes: dict, default_launches: dict,
                large_launches: dict, on_frames: dict) -> list:
    """The ``kernels`` line: one row per kernel, its top-level numbers
    from the shape at which a driven path launched it (the default frame
    first), every shape's numbers under ``shapes``, and both designs'
    device times on the driven and traced frames' own deposits under
    ``on_frame_deposits``."""
    per_kernel = {"bin_deposits": {
        shape: {**shapes[shape]["bin"],
                "max_abs_err": shapes[shape]["bin_max_abs_err"],
                "bound_by": "bytes", "library_ms": None}
        for shape in ("default", "large")}}
    for design in ("direct", "tiled"):
        per_kernel[f"splat_product_{design}"] = per_shape = {}
        for shape in ("default", "large"):
            res = shapes[shape]
            runs = [t for t in res["runs"] if t["design"] == design]
            per_shape[shape] = {
                "deposits": res["m"], "grid": list(res["dim"]),
                "chosen_here": res["chosen"] == design,
                "max_abs_err": res["max_abs_err"][design],
                "ms": min(t["ms"] for t in runs),
                "ms_runs": [t["ms"] for t in runs],
                "bare_ms": min(t["bare_ms"] for t in runs),
                "wrapper_ms": min(t["wrapper_ms"] for t in runs),
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": None}
    rows = []
    for name in COUNTED:
        at = "default" if default_launches[name] else "large"
        rows.append({
            "name": name, "route": "cuda",
            "source": "cpm_tpu_torch/csrc/splat_product.cu",
            "replaces": "cpm_tpu/pallas/splat_mxu.py:57",
            "launches": default_launches[name] or large_launches[name],
            "launches_default_frame": default_launches[name],
            "launches_large_frame": large_launches[name],
            "top_level_shape": at, "held_against_plain": True,
            **per_kernel[name][at], "shapes": per_kernel[name]})
    rows[0]["on_frame_deposits"] = on_frames
    return rows


def delta_row(caller: str, shape: str, launches: dict, calls: int,
              on_list: dict) -> dict:
    """A ``kernels`` row for the splat kernel as a driven path beyond the
    forward frame launches it: the design the wrapper chose on that path's
    own deposit list, with the other design's times beside it.
    ``launches`` are the counts read after ``calls`` calls of the path."""
    chosen = on_list["chosen"]
    launches = launches[f"splat_product_{chosen}"]
    return {
        "name": f"splat_product_{chosen}", "route": "cuda",
        "source": "cpm_tpu_torch/csrc/splat_product.cu",
        "replaces": "cpm_tpu/pallas/splat_mxu.py:57",
        "caller": caller, "shape": shape, "launches": launches,
        "calls": calls, "launches_per_call": launches / calls,
        "held_against_plain": True,
        "max_abs_err": on_list["max_abs_err"][chosen],
        "ms": on_list["median_ms"][chosen], "ms_runs": on_list[chosen],
        "plain_ms": on_list["plain_ms"], "bound_ms": on_list["bound_ms"],
        "bound_by": on_list["bound_by"],
        "share_of_bound": on_list["bound_ms"] / on_list["median_ms"][chosen],
        "library_ms": None,
        "deposits": on_list["deposits"], "live": on_list["live"],
        "other_design_ms_runs": {d: on_list[d] for d in DESIGNS
                                 if d != chosen},
        "other_design_max_abs_err": {d: e for d, e in
                                     on_list["max_abs_err"].items()
                                     if d != chosen}}


def grad_row(grads: dict) -> dict:
    """The ``kernels`` row of the splat's backward: its numbers on the
    default frame's deposits, launches from one ``trajectory_gradients``,
    the delta list's numbers and the rest of the gradients phase."""
    on = grads["on_frame"]
    rest = {k: v for k, v in grads.items() if k not in ("on_frame",
                                                         "on_delta")}
    return {
        "name": "splat_product_grad_cuda", "route": "cuda",
        "source": "cpm_tpu_torch/csrc/splat_product.cu",
        "replaces": "cpm_tpu/ops/splat.py:54",
        "replaces_note": "no TPU kernel: the reference differentiates the "
                         "XLA product splat (splat_product_xla); this is the "
                         "adjoint of cpm_tpu/pallas/splat_mxu.py:57",
        "caller": "score_grad.trajectory_gradients (default frame)",
        "launches": grads["launches"]["splat_product_grad_cuda"],
        "forward_launches_per_gradient": grads["launches"][
            "splat_product_direct"] + grads["launches"][
            "splat_product_tiled"],
        "held_against_plain": True, "max_abs_err": on["max_abs_err"],
        "adjoint_rel": on["adjoint_rel"], "ms": on["ms"],
        "ms_runs": on["ms_runs"], "bare_ms": on["bare_ms"],
        "wrapper_ms": on["wrapper_ms"], "plain_ms": on["plain_ms"],
        "bound_ms": on["bound_ms"], "bound_by": on["bound_by"],
        "share_of_bound": on["share_of_bound"], "library_ms": None,
        "deposits": on["deposits"], "live": on["live"],
        "on_delta_list": grads["on_delta"], "gradients": rest}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    tag = card()
    print(tag)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda)

    # Every library at once, one nvcc each; the compiler's resource report
    # (registers, spills) of each.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = [(mod.SOURCE.name, pool.submit(mod.build))
                  for mod in (sp, wt, ss)]
        for name, fut in builds:
            _, log = fut.result()
            print(f"{name} (-Xptxas -v):\n{log.strip()}")
    print(f"built {', '.join(name for name, _ in builds)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s")

    shapes = check_kernels(dev, tag)

    # --- the main path, counted: the default frame, then the large one ---
    scene, config, state, img, launches, on_default = counted_frame(
        "default frame", dev, tag, reps=50)

    # --- per-stage times (warm), CUDA events ---
    ph = state.photons
    dim = step.light_volume_shape(config)
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
    del img, ph, samples, stages

    # --- the trace kernel against its plain version, timed, and the host
    # waits of a trace and of a packed interactive frame ---
    traced = trace_kernel_phase(scene, config, state, dev, tag)

    # --- the sweep kernels against the plain loop, timed, counted ---
    swept = sweep_kernel_phase(scene, config, state, dev, tag)

    # --- the correlated update at the default frame, counted ---
    correlated = correlated_default(scene, config, state, dev, tag)
    check_small_correlated(dev)

    # --- the tracer's forward options, the marcher, screen-space
    # importance, NEE, mesh spans, counted where they splat ---
    t_slice = time.perf_counter()
    key = rng.fold_in(state.key, 0)
    stats = trace_stats(
        "the default frame",
        lambda on: tracer.trace_photons(
            scene.volume, scene.tf, scene.tf_scattering, state.light_samples,
            key, config.tracer, return_stats=on),
        config.tracer.flights_per_iteration, tag)
    weighted = screen_weighted(scene, config, state, correlated, dev, tag)
    del correlated["drained"], correlated["full_edit"]
    nee_mesh(scene, state, dev, tag)
    del scene, state
    half = float16_frames(dev, tag)
    nss = no_single_scattering_frame(dev, tag)
    marched = march_frame(dev, tag)
    print(f"the tracer's options, the marcher, screen-space importance, NEE "
          f"and the mesh spans took {time.perf_counter() - t_slice:.1f} s")

    # --- trajectory gradients at the default frame and the fit, counted ---
    grads = gradients_default(correlated.pop("delta_list"), dev, tag)
    torch.cuda.empty_cache()

    # --- time-varying playback (config 4), guided emission (config 3) and
    # the other emission modes, counted ---
    t_new = time.perf_counter()
    playback = playback_config4(dev, tag)
    check_small_playback(dev)
    guided = guided_config3(dev, tag)
    lights = other_lights(dev, tag)
    print(f"config 4, config 3 and the other emission modes took "
          f"{time.perf_counter() - t_new:.1f} s")

    # --- multi-device (a world of 1 on NCCL, 2 and 2 x 2 gloo ranks on this
    # card) and the config 1 demo, counted per rank ---
    multi = multi_device(dev, tag)
    demo = demo_config1(dev, tag)
    torch.cuda.empty_cache()

    on_frames = {"default": on_default, **between_frames(tag)}

    # The large frame: a 256^3 cloud, 2048^2 photons x 4 interactions
    # (16,777,216 deposit slots into the same 65^3 grid), a 1024^2 image.
    (scene, config, state, _, large_launches,
     on_frames["large"]) = counted_frame(
        "large frame", dev, tag, reps=5, vol_dim=256, photons=2048,
        width=1024, quadrature_samples=4)
    torch.cuda.empty_cache()
    # One correlated update of the large frame: 419,584 of its photons.
    correlated_big = correlated_large(scene, config, state, dev, tag)
    del scene, state
    torch.cuda.empty_cache()
    on_frames["default correlated step's delta"] = correlated["on_delta"]
    on_frames["large correlated step's added"] = correlated_big["on_added"]
    on_frames["config 4 playback step's delta"] = playback["on_delta"]
    on_frames["config 3 guided frame"] = guided["on_frame"]
    on_frames["float16 frame"] = half["on_frame"]
    on_frames["float16 correlated step's delta"] = half["on_delta"]
    on_frames["no-single-scattering frame"] = nss["on_frame"]
    on_frames["march-rendered frame"] = marched["on_frame"]
    on_frames["screen-weighted correlated step's delta"] = weighted[
        "on_delta"]
    # The wrapper's threshold is held to the deposits the driven paths
    # splat: at every traced size and on every list a correlated step
    # launched, the design it chose is the faster one there, or within
    # CHOICE_SLACK of it (near the threshold the two tie).
    for name, res in on_frames.items():
        chosen = res["median_ms"][res["chosen"]]
        best = res["median_ms"][res["faster"]]
        if chosen > (1.0 + CHOICE_SLACK) * best:
            raise AssertionError(
                f"on the deposits of the {name} the wrapper chooses "
                f"{res['chosen']} ({chosen:.4f} ms) and {res['faster']} "
                f"takes {best:.4f} ms")

    # Both lists of the large step as one signed list, which no driven
    # path splats (correlated_step would, at that frame): reported, not
    # held.
    signed = correlated_big["on_signed"]
    print(f"on the {signed['deposits']} signed slots of both lists together "
          f"the wrapper would choose {signed['chosen']} "
          f"({signed['median_ms'][signed['chosen']]:.4f} ms); "
          f"{signed['faster']} takes "
          f"{signed['median_ms'][signed['faster']]:.4f} ms ({tag})")

    check_small_frame(dev)
    check_beer_lambert(dev)

    rows = kernel_rows(shapes, launches, large_launches, on_frames)
    for row in rows:
        row["caller"] = "full_trace_step"
    slots = correlated["slots"]
    rows.append(delta_row(
        "correlated_step (through step(), default frame)",
        f"{slots} signed delta slots -> 65x65x65x3",
        correlated["launches"], correlated["batches"],
        correlated["on_delta"]))
    rows[-1]["stage_ms"] = correlated["stage_ms"]
    rows[-1]["host_waits_per_step"] = correlated["host_waits"]
    rows[-1]["host_waits_in_retrace"] = correlated["host_waits_in_retrace"]
    rows.append(delta_row(
        "correlated_step_scalable (large frame)",
        f"{correlated_big['slots']} added (and as many removed) slots -> "
        "65x65x65x3", correlated_big["launches"], 1,
        correlated_big["on_added"]))
    rows[-1]["first_run_ms"] = correlated_big["first_run_ms"]
    rows[-1]["on_signed_list"] = correlated_big["on_signed"]
    rows.append(delta_row(
        "advance_time (config 4)",
        f"{playback['on_delta']['deposits']} signed delta slots -> "
        "65x65x65x3", playback["launches"], len(playback["steps"]),
        playback["on_delta"]))
    rows[-1].update({k: playback[k] for k in (
        "steps", "drains", "host_waits", "prepare_ms", "stage_ms")})
    rows.append(delta_row(
        "full_trace_step (guided, config 3)",
        f"{guided['on_frame']['deposits']} deposit slots -> 65x65x65x3",
        guided["launches"], 1, guided["on_frame"]))
    rows[-1].update({k: guided[k] for k in (
        "stage_ms", "variance_uniform", "variance_guided", "bias",
        "tick_ms")})
    rows[-1]["other_emission_frames"] = lights
    rows[-1]["debug_image_ms"] = guided["debug_image_ms"]
    rows.append(delta_row(
        "full_trace_step (float16 photons, default frame at 2 interactions)",
        f"{half['on_frame']['deposits']} deposit slots -> 65x65x65x3",
        half["launches"], 1, half["on_frame"]))
    rows[-1].update({k: half[k] for k in (
        "first_run_ms", "in_turns", "light_volume_rel_l1",
        "overflow_at_4_interactions")})
    rows.append(delta_row(
        "correlated_step (float16 photons, drain after the TF edit)",
        f"{half['on_delta']['deposits']} signed delta slots -> 65x65x65x3",
        half["drain_launches"], half["batches"], half["on_delta"]))
    rows[-1]["drain_ms"] = half["drain_ms"]
    rows.append(delta_row(
        "full_trace_step (no single scattering)",
        f"{nss['on_frame']['deposits']} deposit slots -> 65x65x65x3",
        nss["launches"], 1, nss["on_frame"]))
    rows[-1].update({k: nss[k] for k in ("first_run_ms", "frame_ms")})
    rows.append(delta_row(
        "full_trace_step (frame rendered by the gather marcher)",
        f"{marched['on_frame']['deposits']} deposit slots -> 65x65x65x3",
        marched["launches"], 1, marched["on_frame"]))
    rows[-1].update({k: marched[k] for k in (
        "first_run_ms", "n_steps", "chunks", "dense_vs_loop_max_abs_err",
        "oracle_max_abs_err", "in_turns", "host_waits", "eye_inside")})
    rows.append(delta_row(
        "correlated_step (screen-weighted grid, drain after the TF edit)",
        f"{weighted['on_delta']['deposits']} signed delta slots -> "
        "65x65x65x3", weighted["launches"], weighted["batches"],
        weighted["on_delta"]))
    rows[-1]["drain_ms"] = weighted["drain_ms"]
    rows.append(grad_row(grads))
    for key, caller in (
            ("world2", "sharded_trace_splat (sharded_full_step, 2 gloo ranks "
                       "on one card, default frame)"),
            ("world4", "multihost_trace_splat (multihost_full_step, 2 hosts "
                       "x 2 chips, gloo, on one card, default frame)")):
        world = multi[key]
        rows.append(delta_row(
            caller, f"{world['slots']} deposit slots of one rank's shard -> "
            "65x65x65x3", world["launches"], 1, world["on_shard"]))
        rows[-1].update({k: world[k] for k in (
            "world", "wall_s", "errors", "launches_per_rank",
            "stage_ms_per_rank")})
    rows[-2]["world_of_1_nccl"] = multi["world1_nccl"]
    rows.append(delta_row(
        "examples/render_sphere_torch.py (config 1 demo, first and steady "
        "run)", f"{demo['on_list']['deposits']} deposit slots -> 65x65x65x3",
        demo["launches"], 2, demo["on_list"]))
    rows[-1].update({k: demo[k] for k in (
        "wall_s", "first_ms", "steady_ms", "deposited", "alpha_max")})
    rows[0]["trace_stats"] = {"default frame": stats,
                              "config 4 step retrace": playback[
                                  "trace_stats"]}
    rows.append(trace_row(
        traced, launches["trace_woodcock_cuda"],
        {"config 4 step 1 retrace": playback["trace_check"],
         "config 3 guided frame": guided["trace_check"]}))
    rows[-1]["config 4 advance_time in turns"] = playback["step_in_turns"]
    rows[-1]["config 1 demo trace"] = demo["trace_stats"]
    sweeps = "sweep_scan_forward"
    by_path = {
        "full_trace_step + render_state (default frame)": launches[sweeps],
        "interactive_frame": traced["interactive_frame"]["launches"][sweeps],
        "correlated drain + render_state": correlated["launches"][sweeps],
        "eye inside (render)": swept["lists"]["eye inside"]["launches"],
        "entry.entry forward": swept["entry_launches"][sweeps],
        "float16 frame": half["launches"][sweeps],
        "config 3 guided frame": guided["launches"][sweeps],
        "world of 1 (nccl), sharded_full_step": multi["world1_nccl"][
            "sweep"]["launches"][sweeps],
        "gloo ranks of 2, sharded_full_step, per rank": [
            r[sweeps] for r in multi["world2"]["launches_per_rank"]["sweep"]],
        "2 hosts x 2 chips, multihost_full_step, per rank": [
            r[sweeps] for r in multi["world4"]["launches_per_rank"]["sweep"]],
        "config 1 demo (two runs)": demo["launches"][sweeps],
        "linear image loss gradient": grads["linear_launches"][sweeps],
        "trajectory_gradients": grads["launches"][sweeps],
        "fit_tf_torch (12 steps)": grads["fit"]["launches"][sweeps]}
    rows.extend(sweep_rows(
        swept, by_path, launches["sweep_planes"],
        grads["launches"]["sweep_scan_backward"],
        grads["launches"]["sweep_fold"],
        {"config 3 guided frame": guided["sweep_check"],
         "float16 frame": half["sweep_check"],
         "float16 light volume at 4 interactions (+inf texels)": half[
             "sweep_check_at_4_interactions"],
         "float16 NaN pixels at 4 interactions": half[
             "sweep_nan_pixels_at_4_interactions"],
         "grad launches by path": {
             "linear image loss gradient": grads["linear_launches"][
                 "sweep_scan_backward"],
             "fit_tf_torch (12 steps)": grads["fit"]["launches"][
                 "sweep_scan_backward"]}}))
    for row in rows:
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} was launched by no driven "
                                 f"path ({row['caller']})")
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(f"profiler windows: {dict(WINDOWS)}; records the short ones "
          f"lacked: {dict(MISSING)} (a short window's time is each name's "
          "mean record times its known launches per call)")
    print(tag)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""One frame of time-varying playback, as an application plays a sequence
(``pipeline/timevarying.advance_time``): the playback time moves on by a
draw from ``dt_steps`` (in steps, cyclic over the sequence), the volume
is interpolated there and swapped into the scene, and one correlated
batch of a fresh drain round updates the photon map under the
time-varying importance grid. It hands the next steps the time
(``ctx["time"]``).

The sequence (``sequence(spec, generator, device)`` of the configuration's
volume kind, whose step 0 the set-up traced) is made and prepared in the
set-up: on the program's side by ``VolumeSequence.prepare``.

Checked twice: a sampled frame from the program's state before it (its
photon map and light volume) through the reference's mix, difference
grid, importance, selection, retrace and splats
(:mod:`cpmbench.reference.timevarying`); and, once the window has closed,
the last state's light volume, which every batch of the window updated in
place, against the reference's splat of the last photon map
(``drift_err``).

``drift_err`` is max |program - reference| over the largest magnitude the
light volume held in the run (``mem["peak"]``, kept on the card with no
host wait), not over the last volume's own peak. Photon powers grow
with each interaction (a fourth interaction's deposit can be ~1e5 times
the median one), so the volume's peak swings by hundreds of times from
frame to frame as the few lanes that carry the largest deposits are
retraced, and a float32 in-place update keeps a residue of some ulps of
every value a cell once held: measured against a small last peak, that
residue can read ~5e-4; against the largest value the update handled,
~1e-6."""

import dataclasses

import numpy as np
import torch

from cpmbench.harness.check import lanes_differ, rel_err
from cpmbench.reference import timevarying as R


def prepare_program(side, volumes):
    from cpm_tpu_torch.pipeline import timevarying
    return timevarying.VolumeSequence.prepare(
        volumes, side.config.recompute.grid_cell_size, device=side.device)


def prepare_reference(side, volumes):
    return R.prepare(volumes, side.config.recompute.grid_cell_size)


def program(side, scene, state, seq, time):
    from cpm_tpu_torch.pipeline import timevarying
    return timevarying.advance_time(scene, state, seq, time, side.config)


def reference(side, scene, state, seq, time):
    scene, out = R.advance_time(
        scene, state.light_samples, state.key, side.config, state.photons,
        state.light_volume, seq, time, p=side.p)
    return scene, dataclasses.replace(
        state, photons=out["photons"], light_volume=out["light_volume"],
        light_volume_accum=out["light_volume"])


def setup(s, step):
    spec = s.cfg["volume"]
    g = torch.Generator(device=s.device)
    g.manual_seed(s.seed)
    s.sequence = s.registry.volume(spec["kind"]).sequence(
        spec, g, s.device).contiguous()
    step.mem["seq"] = s.on(prepare_program, prepare_reference)(s.sequence)
    step.mem["time"] = 0.0
    step.mem["peak"] = peak(s.state.light_volume)


def peak(light_volume):
    """max |light volume|, a scalar on the volume's device."""
    return torch.linalg.vector_norm(light_volume, float("inf"))


def run(s, step, ctx, record):
    lo, hi = step.params["dt_steps"]
    mem = step.mem
    time = float(np.float32((mem["time"] + s.draws.uniform(lo, hi))
                            % s.sequence.shape[0]))
    before = s.state
    s.scene, s.state = s.on(program, reference)(s.scene, s.state, mem["seq"],
                                                time)
    mem["time"] = ctx["time"] = time
    mem["peak"] = torch.maximum(mem["peak"], peak(s.state.light_volume))
    s.counts["frames"] += 1
    if record is not None:
        record.steps.append(("advance_time", {
            "before": before, "after": s.state, "time": time}))


def check(c, f):
    before = f["before"]
    _, out = R.advance_time(
        c.base, c.start.light_samples, c.start.key, c.ref.config,
        before.photons, before.light_volume,
        prepare_reference(c.ref, c.s.sequence), f["time"])
    c.note("photons_differ", lanes_differ(f["after"].photons, out["photons"]))
    c.note("light_volume_err", rel_err(f["after"].light_volume,
                                       out["light_volume"]))
    c.carry["light_volume"] = out["light_volume"]


def final(c, step, state):
    want = c.ref.P.splat.splat_all(state.photons,
                                   c.ref.P.light_volume_shape(c.ref.config))
    top = float(want.abs().max())
    c.note("drift_err", rel_err(state.light_volume, want) * top
           / max(float(step.mem["peak"]), top, 1e-30))

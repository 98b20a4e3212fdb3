"""The benchmark's playback cell (``cfg4-playback``) at the tests' small
size on the CPU (a 24^3 x 6-step orbiting sphere, 32 x 32 photons, a 32^2
image, three frames of warm-up so that the sampled frame lies past step
0): a sound run reads correct, and what the comparison should fail reads
not correct: the bfloat16 control (the TF32 control on the card), and
four faults planted in the program's playback: the volume left at its
floor step (no mix), step 0's difference grid on every frame, the
frame's correlated batch skipped, and the first warm-up frame's light
volume update 1% heavy, which no sampled frame sees and ``drift_err``
catches."""

import contextlib
import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from cpmbench.harness.backends import ReferenceBackend
from cpmbench.reference.pipeline import CONTROLS
from cpmbench.tests.conftest import ROOT, run_small
from cpm_tpu_torch.ops import mixer, splat
from cpm_tpu_torch.pipeline import step as pstep
from cpm_tpu_torch.pipeline import timevarying as tv

WORKLOAD = "cfg4-playback"
SMALL = {"volume": {"kind": "orbiting_sphere", "dim": 24, "steps": 6}}
WARMUP = {"warmup": 3}


def no_mix(fn):
    """The sequence's floor step at every time."""
    def sample(sequence, time):
        return sequence[tv.floor_step(time, sequence.shape[0])]
    return sample


def step0_grid(fn):
    """Step 0's difference grid whatever the time."""
    def importance(seq_minmax, seq_diff, *args, **kwargs):
        return fn(seq_minmax, seq_diff[:1].expand_as(seq_diff), *args,
                  **kwargs)
    return importance


def skipped(fn):
    def correlated_step(scene, state, *args, **kwargs):
        return state
    return correlated_step


def heavy_first_frame(fn):
    """The first frame's light volume update 1% heavy."""
    calls = []

    def splat_selected_delta(*args, **kwargs):
        calls.append(1)
        out = fn(*args, **kwargs)
        return out * 1.01 if len(calls) == 1 else out
    return splat_selected_delta


FAULTS = {f.__name__: (module, attr, f) for module, attr, f in [
    (mixer, "sequence_sample", no_mix),
    (tv, "time_step_importance", step0_grid),
    (pstep, "correlated_step", skipped),
    (splat, "splat_selected_delta", heavy_first_frame)]}


@contextlib.contextmanager
def planted(fault):
    if fault is None:
        yield
        return
    module, attr, wrap = FAULTS[fault]
    fn = getattr(module, attr)
    setattr(module, attr, wrap(fn))
    try:
        yield
    finally:
        setattr(module, attr, fn)


def outcomes(cases, device="cpu") -> dict:
    """Each case's run: a control's name, a fault's or "sound". Run where
    JAX is not loaded, since the harness refuses a run that loaded it."""
    out = {}
    for case in cases:
        side = (functools.partial(ReferenceBackend, precision=CONTROLS[case])
                if case in CONTROLS else None)
        torch.manual_seed(0)
        with planted(case if case in FAULTS else None):
            r = run_small(WORKLOAD, cfg=SMALL, mix=WARMUP, side=side,
                          device=device)
        out[case] = {"correct": r["correct"], "checks": r["checks"],
                     "attempted": r["attempted"],
                     "metrics": sorted(r["metrics"])}
    return out


# The probe loads this file by its path: a package named ``tests``
# installed elsewhere may shadow the repository's folder.
PROBE = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("playback_cases", {path!r})
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
print(json.dumps(module.outcomes({cases!r}, {device!r})))
"""


def outcomes_apart(cases, device="cpu") -> dict:
    """:func:`outcomes` in a process of its own (this one loaded JAX)."""
    run = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), path=__file__,
                                           cases=cases, device=device)],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cpu_runs():
    return outcomes_apart(["sound", "bfloat16", *FAULTS])


def test_the_cell_reads_correct_on_the_cpu(cpu_runs):
    r = cpu_runs["sound"]
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"photons_differ", "light_volume_err",
                                "image_err", "drift_err"}
    assert r["attempted"] >= 1
    assert {"frame_ms_p95", "frames_per_s", "setup_s"} <= set(r["metrics"])


def test_the_bfloat16_control_is_not_correct_on_the_cpu(cpu_runs):
    r = cpu_runs["bfloat16"]
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU has no TF32 products")
    r = outcomes_apart(["tf32"], device="cuda")["tf32"]
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_not_correct(cpu_runs, fault):
    r = cpu_runs[fault]
    assert not r["correct"], r["checks"]


def test_drift_outside_the_sample_is_not_correct(cpu_runs):
    """The heavy warm-up frame passes every sampled number and fails
    ``drift_err``, which holds the window's last light volume against the
    splat of its last photon map over the largest value the volume held."""
    c = cpu_runs["heavy_first_frame"]["checks"]
    for name in ("photons_differ", "light_volume_err", "image_err"):
        assert c[name]["value"] <= c[name]["limit"], c
    assert c["drift_err"]["value"] > c["drift_err"]["limit"], c


PLAYBACK_METRICS = ("playback_idle_ms.playback", "importance_idle_ms.playback",
                    "host_wait_ms.playback", "device_idle_pct.playback",
                    "render_replay_pct.playback")


def _readings(monkeypatch, snap, device):
    """Each playback reader's reading of a 100-us traced window of two
    frames whose device intervals are ``device`` and whose program
    recorder holds ``snap`` (None: no recorder)."""
    from cpmbench.harness.cell import Run
    from cpmbench.harness.devtrace import DeviceTrace
    from cpmbench.harness.registry import Registry
    from cpmbench.metrics import _program
    monkeypatch.setattr(_program, "_cache", {})
    reg = Registry(ROOT)
    for name in PLAYBACK_METRICS:
        module = reg.module("metrics", name)
        if hasattr(module, "snapshot"):
            monkeypatch.setattr(module, "snapshot", lambda: snap)
    monkeypatch.setattr(_program, "snapshot", lambda: snap)
    run = Run(device=torch.device("cpu"), cfg={}, setup_s=0.0,
              latencies_s=[0.1, 0.1], window_s=1.0,
              counts={"interactions": 2, "frames": 2},
              trace=DeviceTrace(window=(0.0, 100.0), device=device),
              host_waits=1.0)
    return {name: reg.reader(name)(run) for name in PLAYBACK_METRICS}


def test_the_playback_readers_read_the_programs_spans(monkeypatch):
    # Spans (ns): a frame's step with its importance grid (an upload
    # inside) and its path importance, then the render's replay.
    snap = {"spans": [("playback.advance_time", -1, 0, 60_000),
                      ("playback.importance", 0, 2_000, 30_000),
                      ("wait.playback.volume_dim", 1, 10_000, 20_000),
                      ("importance.path", 0, 35_000, 50_000),
                      ("render.replay", -1, 70_000, 95_000)],
            "counters": {"wait.playback.volume_dim": 2,
                         "playback.frames": 2, "playback.new_step": 1,
                         "render.graph_replays": 3,
                         "render.graph_captures": 1},
            "launches": {}}
    got = _readings(monkeypatch, snap,
                    [("k", 0.0, 5.0), ("k", 25.0, 40.0), ("k", 80.0, 90.0)])
    # Idle (us): [5, 25] under the importance grid, its layer playback;
    # [40, 80] starts in the path importance (playback and importance);
    # [90, 100] under the replay.
    assert got["playback_idle_ms.playback"] == pytest.approx(60e-3 / 2)
    assert got["importance_idle_ms.playback"] == pytest.approx(40e-3 / 2)
    assert got["host_wait_ms.playback"] == pytest.approx(10e-3 / 2)
    assert got["device_idle_pct.playback"] == pytest.approx(70.0)
    assert got["render_replay_pct.playback"] == pytest.approx(75.0)


def test_the_playback_readers_on_a_program_without_their_spans(monkeypatch):
    """A program without the playback spans (the parent of the change that
    added them) gives no playback reading and raises nothing; without the
    recorder only the device's idle share reads."""
    snap = {"spans": [("importance.path", -1, 0, 40_000),
                      ("wait.step.n_remaining", 0, 10_000, 20_000)],
            "counters": {"wait.step.n_remaining": 2,
                         "render.graph_replays": 1}, "launches": {}}
    device = [("k", 50.0, 60.0)]
    got = _readings(monkeypatch, snap, device)
    assert got["playback_idle_ms.playback"] is None
    # Idle [0, 50] starts in the path importance, [60, 100] in no span.
    assert got["importance_idle_ms.playback"] == pytest.approx(50e-3 / 2)
    assert got["host_wait_ms.playback"] == pytest.approx(10e-3 / 2)
    got = _readings(monkeypatch, None, device)
    assert got == {**{name: None for name in PLAYBACK_METRICS},
                   "device_idle_pct.playback": pytest.approx(90.0)}

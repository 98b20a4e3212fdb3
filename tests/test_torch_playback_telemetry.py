"""The recorder (``cpm_tpu_torch/core/telemetry.py``) in time-varying
playback, on the CPU (a 16^3 x 4-step orbiting sphere, 16^2 photons):

- under ``torch.profiler.profile`` one ``advance_time`` is the span
  ``playback.advance_time`` with ``playback.mix``, ``playback.importance``
  and the correlated step inside it, and its host waits are named:
  ``wait.playback.volume_dim`` and the importance's uploads inside
  ``playback.importance``; ``VolumeSequence.prepare`` is the span
  ``playback.prepare`` around its upload ``wait.playback.sequence``;
- without a profiler nothing of that is recorded;
- the counters ``playback.frames`` and ``playback.new_step`` count always.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                       TracerConfig)
from cpm_tpu_torch.core.lights import Light
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.io import synthetic
from cpm_tpu_torch.pipeline import step
from cpm_tpu_torch.pipeline import timevarying as tv

DIM, STEPS = 16, 4
COUNTERS = ("playback.frames", "playback.new_step")


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(1)
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def played():
    torch.set_num_threads(1)
    vols = synthetic.time_varying_sequence(DIM, STEPS)
    pos, col = synthetic.default_tf_points()
    scene = Scene.create(
        ttypes.Volume.from_data(vols[0], device="cpu"),
        ttypes.TransferFunction.from_points(pos, col, device="cpu"),
        ttypes.TransferFunction.from_points(
            *synthetic.default_scattering_points(), device="cpu"),
        [Light.directional((0.0, -1.0, 0.3))], Camera.create(device="cpu"))
    config = PipelineConfig(
        photons_x=16, photons_y=16,
        tracer=TracerConfig(max_interactions=2, max_steps=400),
        render=RenderConfig(width=16, height=16))
    state = step.full_trace_step(scene, step.init_state(scene, config),
                                 config)
    return vols, scene, config, state


def _within(spans, name, outer):
    """The spans named ``name`` whose chain of parents reaches index
    ``outer``."""
    out = []
    for i, s in enumerate(spans):
        if s[0] != name:
            continue
        j = s[1]
        while j >= 0 and j != outer:
            j = spans[j][1]
        if j == outer:
            out.append(i)
    return out


def test_one_advance_time_records_its_spans_and_waits(played):
    vols, scene, config, state = played
    seq = tv.VolumeSequence.prepare(vols, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        tv.advance_time(scene, state, seq, 1.5, config)
    snap = telemetry.snapshot()
    spans = snap["spans"]
    top = [i for i, s in enumerate(spans)
           if s[0] == "playback.advance_time"]
    assert len(top) == 1 and spans[top[0]][1] == -1
    (outer,) = top
    for name in ("playback.mix", "playback.importance",
                 "pipeline.correlated_step"):
        inside = _within(spans, name, outer)
        assert len(inside) == 1 and spans[inside[0]][1] == outer, name
    importance = _within(spans, "playback.importance", outer)[0]
    for site in ("playback.volume_dim", "importance.rgb_to_xyz",
                 "importance.white_d65"):
        assert _within(spans, f"wait.{site}", importance), site
    c = snap["counters"]
    assert c["wait.playback.volume_dim"] == 1
    # Two colours of the envelope, each through rgb2lab's two uploads.
    assert c["wait.importance.rgb_to_xyz"] == 2
    assert c["wait.importance.white_d65"] == 2
    assert c["wait.step.n_remaining"] == 1
    named = sum(v for k, v in c.items() if k.startswith("wait."))
    waits = sum(1 for s in spans if s[0].startswith("wait."))
    assert named == waits
    assert all(s[3] is not None for s in spans)
    assert {k: c[k] for k in COUNTERS} == {k: 1 for k in COUNTERS}


def test_prepare_is_a_span_around_its_upload(played):
    vols = played[0]
    with profile(activities=[ProfilerActivity.CPU]):
        seq = tv.VolumeSequence.prepare(vols, device="cpu")
    spans = telemetry.snapshot()["spans"]
    (outer,) = [i for i, s in enumerate(spans)
                if s[0] == "playback.prepare"]
    assert _within(spans, "wait.playback.sequence", outer)
    assert telemetry.snapshot()["counters"]["wait.playback.sequence"] == 1
    assert seq.volumes.shape[0] == STEPS


def test_nothing_is_recorded_without_a_profiler(played):
    vols, scene, config, state = played
    seq = tv.VolumeSequence.prepare(vols, device="cpu")
    tv.advance_time(scene, state, seq, 0.5, config)
    snap = telemetry.snapshot()
    assert snap["spans"] == []
    assert not any(k.startswith("wait.") for k in snap["counters"])


@pytest.mark.parametrize("times,new", [
    ([0.3, 0.8, 1.1, 1.2, 3.0, 0.5], 4),
    ([3.5, 4.25, 4.9, 8.0], 2),  # 4.25 and 8.0: step 0 of later cycles
])
def test_frames_and_new_steps_count_always(played, times, new):
    vols, scene, config, state = played
    seq = tv.VolumeSequence.prepare(vols, device="cpu")
    for t in times:
        scene, state = tv.advance_time(scene, state, seq, t, config,
                                       correlated=False)
    assert not telemetry.recording()
    counters = telemetry.snapshot()["counters"]
    assert counters == {"playback.frames": len(times),
                        "playback.new_step": new}
    # A reset forgets the last frame's step: the next frame is a new one.
    telemetry.reset()
    tv.advance_time(scene, state, seq, times[-1], config, correlated=False)
    assert telemetry.snapshot()["counters"]["playback.new_step"] == 1

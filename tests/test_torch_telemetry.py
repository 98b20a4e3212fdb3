"""The recorder (``cpm_tpu_torch/core/telemetry.py``): spans, host waits and
counters, on the CPU unless marked ``cuda``.

- Nothing is recorded without a profiler; a span is then a flag test.
- Under ``torch.profiler.profile`` the spans of a correlated step, a
  render and a progressive pass nest as the pipeline calls its stages, and
  their stamps lie within 1 ms of the profiler's own host events.
- The host-wait helper returns what the wrapped call returns and counts
  its sites while recording.
- The launch counters count always.
- The trace's counters (tentative and accepted collisions) equal what
  its event tape records, in the wavefront loop here and in
  the kernel on the card, and counting changes no bit of the trace.
- The trace kernel's argument struct is mirrored field for field.
"""

import dataclasses
import re

import numpy as np
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
from cpm_tpu_torch.kernels import woodcock_trace as wt
from cpm_tpu_torch.ops import emit, sampling, tracer
from cpm_tpu_torch.pipeline import step

FIELDS = ("positions", "powers", "directions", "exit_power",
          "exit_direction")
TRACE_COUNTERS = telemetry.DEVICE_COUNTERS


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    telemetry.reset()
    yield
    telemetry.reset()


def _scene(dim=16, device="cpu"):
    vol = ttypes.Volume.from_data(synthetic.smoke_cloud(dim, seed=4),
                                  device=device)
    pos, col = synthetic.default_tf_points()
    return Scene.create(
        vol, ttypes.TransferFunction.from_points(pos, col, device=device),
        ttypes.TransferFunction.from_points(
            *synthetic.default_scattering_points(), device=device),
        [Light.directional((0.0, -1.0, 0.3))], Camera.create(device=device))


def _config():
    return PipelineConfig(
        photons_x=16, photons_y=16,
        tracer=TracerConfig(max_interactions=2, max_steps=400),
        render=RenderConfig(width=16, height=16))


def _edited(scene):
    pos, col = synthetic.default_tf_points()
    col = np.array(col, np.float32)
    col[:, 3] *= 1.3
    return dataclasses.replace(scene, tf=ttypes.TransferFunction.from_points(
        pos, col, device=scene.device))


def _interaction(scene, state, config):
    """An edit's path: the TF-change grid, a correlated batch, a render,
    then a progressive pass."""
    edited = _edited(scene)
    grid = step.build_tf_change_importance_grid(
        edited, config, scene.tf.positions, scene.tf.colors)
    state = step.correlated_step_scalable(
        edited, state, config, grid,
        step.recompute_budget(config, state.photons.n))
    image = step.render_state(edited, state, config)
    return step.progressive_step(edited, state, config), image


@pytest.fixture(scope="module")
def traced():
    torch.set_num_threads(2)
    scene, config = _scene(), _config()
    return scene, config, step.full_trace_step(
        scene, step.init_state(scene, config), config)


def _by_name(spans):
    out = {}
    for i, s in enumerate(spans):
        out.setdefault(s[0], []).append(i)
    return out


def test_nothing_is_recorded_without_a_profiler(traced):
    scene, config, state = traced
    assert not telemetry.recording()
    _interaction(scene, state, config)
    snap = telemetry.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    assert telemetry.span("x") is telemetry.span("y")  # one shared no-op
    assert telemetry.device_counters("cpu") is None
    assert telemetry.wait("a", int, torch.tensor(3)) == 3
    assert telemetry.snapshot()["counters"] == {}


def test_spans_nest_as_the_pipeline_calls_its_stages(traced):
    scene, config, state = traced
    with profile(activities=[ProfilerActivity.CPU]):
        _interaction(scene, state, config)
    spans = telemetry.snapshot()["spans"]
    names = _by_name(spans)

    def parent(i):
        p = spans[i][1]
        return spans[p][0] if p >= 0 else None

    for name, want in (
            ("importance.minmax", "importance.tf_change_grid"),
            ("importance.tf_difference", "importance.tf_change_grid"),
            ("wait.importance.tf_points", "importance.tf_difference"),
            ("importance.path", "pipeline.correlated_step_scalable"),
            ("importance.select", "pipeline.correlated_step_scalable"),
            ("pipeline.selected_samples",
             "pipeline.correlated_step_scalable"),
            ("pipeline.retrace", "pipeline.correlated_step_scalable"),
            ("pipeline.merge_recomputed",
             "pipeline.correlated_step_scalable"),
            ("pipeline.after_batch", "pipeline.correlated_step_scalable"),
            ("trace.constants", "trace.photons"),
            ("trace.grids", "trace.constants"),
            ("trace.wavefront", "trace.photons"),
            ("trace.outputs", "trace.photons"),
            ("render.sweep", "pipeline.render_state"),
            ("render.plan", "render.sweep"),
            ("render.principal_axis", "render.sweep"),
            ("render.permute", "render.sweep"),
            ("render.schedule", "render.plan"),
            ("render.scan", "render.sweep"),
            ("render.warp", "render.sweep"),
            ("wait.step.iteration", "pipeline.progressive_step")):
        assert name in names, name
        assert {parent(i) for i in names[name]} == {want}, name
    # The render reads nothing back from the card.
    assert not {"wait.render.z_base", "wait.camera.host",
                "wait.camera.fov"} & set(names)
    assert {parent(i) for i in names["trace.photons"]} == {
        "pipeline.retrace", "pipeline.progressive_step"}
    assert {parent(i) for i in names["splat.deposits"]} == {
        "splat.selected", "splat.all"}
    # Two splats of the batch, one of the pass.
    assert len(names["splat.selected"]) == 2
    assert len(names["splat.all"]) == 1
    for i, (name, p, start, end) in enumerate(spans):
        assert end is not None and start <= end, name
        if p >= 0:
            assert spans[p][2] <= start and end <= spans[p][3], name
    roots = [s[0] for s in spans if s[1] < 0]
    assert roots == ["scene.transfer_function", "importance.tf_change_grid",
                     "pipeline.correlated_step_scalable",
                     "pipeline.render_state", "pipeline.progressive_step"]


def test_span_stamps_lie_on_the_profilers_host_clock(traced):
    """A span and a profiler range around the same call start and end
    within 1 ms of each other, the span inside the range (the profiler's
    first range of a window pays a start-up cost, so a range before it)."""
    scene, config, state = traced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("probe.first"):
            pass
        with torch.profiler.record_function("probe.render"):
            step.render_state(scene, state, config)
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe.render"]
    assert len(probe) == 1
    start = probe[0].start_ns()
    end = start + probe[0].duration_ns()
    (span,) = [s for s in telemetry.snapshot()["spans"]
               if s[0] == "pipeline.render_state"]
    assert start <= span[2] < start + 1e6
    assert end - 1e6 < span[3] <= end
    assert span[3] - span[2] > 0


def _open_spans():
    return [s[0] for s in telemetry.snapshot()["spans"] if s[3] is None]


def test_host_wait_helpers_name_their_sites():
    t = torch.arange(4)
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.wait("probe.list", torch.Tensor.tolist, t) == [
            0, 1, 2, 3]
        assert telemetry.wait("probe.list", int, t[2]) == 2
        up = telemetry.wait("probe.up", torch.tensor, [1.0, 2.0],
                            dtype=torch.float32)
        with telemetry.span("outer"):
            telemetry.wait("probe.inner", float, t[1])
            assert _open_spans() == ["outer"]
    assert up.dtype == torch.float32 and up.tolist() == [1.0, 2.0]
    snap = telemetry.snapshot()
    assert snap["counters"] == {"wait.probe.list": 2, "wait.probe.up": 1,
                                "wait.probe.inner": 1}
    assert [s[0] for s in snap["spans"]] == [
        "wait.probe.list", "wait.probe.list", "wait.probe.up", "outer",
        "wait.probe.inner"]
    assert snap["spans"][4][1] == 3
    assert _open_spans() == []


def test_a_span_closes_when_its_block_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ZeroDivisionError):
            with telemetry.span("fails"):
                1 / 0
        assert _open_spans() == []
    (span,) = telemetry.snapshot()["spans"]
    assert span[0] == "fails" and span[3] is not None


def test_launches_are_counted_always_and_reset_clears_them():
    assert not telemetry.recording()
    telemetry.launched("probe_kernel")
    telemetry.launched("probe_kernel")
    assert telemetry.launches("probe_kernel") == 2
    assert telemetry.snapshot()["launches"] == {"probe_kernel": 2}
    telemetry.reset()
    assert telemetry.launches("probe_kernel") == 0
    assert telemetry.snapshot()["launches"] == {}


def _samples(scene, n=12):
    return emit.emit(Light.directional((0.0, -1.0, 0.3)),
                     sampling.stratified_grid_2d(n, n, device=scene.device))


def _tape_counts(events):
    """(tentative, accepted collisions) as the tape has them: every
    acceptance test, and the ones that scattered, were absorbed or stopped
    at the cap (a first event of a no-single-scattering lane deposits
    nothing and is not an interaction)."""
    assert int(events.counts.max()) <= events.types.shape[1]
    accepted = sum(int((events.types == t).sum()) for t in (
        tracer.EVT_SCATTER, tracer.EVT_ABSORB, tracer.EVT_FORCED))
    return int(events.counts.sum()), accepted


def _counted():
    c = telemetry.snapshot()["counters"]
    return tuple(c.get(name, 0) for name in TRACE_COUNTERS)


@pytest.mark.parametrize("nss", [False, True])
def test_wavefront_counters_equal_its_event_tape(nss):
    scene = _scene()
    samples = _samples(scene)
    cfg = TracerConfig(max_interactions=3, max_steps=400,
                       no_single_scattering=nss)
    args = (scene.volume, scene.tf, scene.tf_scattering, samples, (5, 9),
            cfg)
    plain = tracer.trace_photons(*args)
    with profile(activities=[ProfilerActivity.CPU]):
        got, events = tracer.trace_photons(*args, record_events=96)
    tests, accepted = _counted()
    assert (tests, accepted) == _tape_counts(events)
    assert 0 < accepted < tests
    # Counting changes nothing the trace returns.
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


def test_chunked_trace_counts_every_chunk():
    scene = _scene()
    samples = _samples(scene)
    cfg = TracerConfig(max_interactions=2, max_steps=400)
    args = (scene.volume, scene.tf, scene.tf_scattering, samples, (2, 7),
            cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        tracer.trace_photons(*args)
    whole = _counted()
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tracer.trace_photons_chunked(*args, chunk=50)
    assert _counted() == whole
    spans = telemetry.snapshot()["spans"]
    assert sum(s[0] == "trace.photons" for s in spans) == 3


@pytest.mark.parametrize("struct,mirror", [("TraceArgs", wt._Args),
                                           ("GridArgs", wt._GridArgs)])
def test_the_wrappers_arguments_mirror_the_sources_struct(struct, mirror):
    """``kernels/woodcock_trace``'s ctypes structures hold the fields of
    the source's structs, in order and each once, with C's types (the
    counters' pointer included)."""
    import ctypes

    body = re.search(rf"struct {struct} \{{(.*?)\n\}};",
                     wt.SOURCE.read_text(), re.S).group(1)
    want = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        if "*" in decl:
            kind, names = "ptr", decl.split("*", 1)[1]
        else:
            ctype, names = decl.rsplit(None, 1)[0], decl.rsplit(None, 1)[1]
            if "," in decl:
                ctype, names = decl.split(None, 1)
                if ctype == "unsigned":
                    ctype, names = "unsigned int", names.split(None, 1)[1]
            kind = {"int": "int", "unsigned int": "uint",
                    "float": "float"}[ctype]
        for name in names.split(","):
            name = name.strip()
            m = re.fullmatch(r"(\w+)\[(\d+)\]", name)
            want.append((m.group(1), f"{kind}[{m.group(2)}]") if m
                        else (name, kind))
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_uint: "uint", ctypes.c_float: "float",
             ctypes.c_float * 3: "float[3]"}
    got = [(name, kinds[t]) for name, t in mirror._fields_]
    assert got == want
    assert len({name for name, _ in got}) == len(got)
    if struct == "TraceArgs":
        assert ("counts", "ptr") in got


# --- on the card ---------------------------------------------------------


@pytest.fixture(scope="module")
def card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    scene, config = chip_smoke.build_frame()
    return scene, config, step.init_state(scene, config)


# (launch shape or None, tape rows): a grid too small for the list
# compacts and refills; a tape counts its tests itself.
CARD_SHAPES = {"default": (None, 0),
               "refill": ((128, 8, 4), 0),
               "tape": (None, 64),
               "refill_tape": ((128, 8, 4), 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_SHAPES))
def test_kernel_counters_equal_the_wavefronts_on_the_card(card_frame, case,
                                                          monkeypatch):
    """The default frame (65,536 lanes) through the kernel with and
    without the counters: the two counts equal the wavefront loop's, and
    the kernel's outputs (and tape) are bit-equal with counting on and
    off."""
    import chip_smoke
    scene, config, state = card_frame
    launch, tape = CARD_SHAPES[case]
    if launch is not None:
        shape = wt.LaunchShape(*launch)
        monkeypatch.setattr(wt, "launch_shape", lambda n, sms, per_sm: shape)
    args = (scene.volume, scene.tf, scene.tf_scattering,
            state.light_samples, (11, 4), config.tracer)
    kw = {"record_events": tape} if tape else {}

    def run(method):
        out = tracer.trace_photons(*args, method=method, **kw)
        return out if tape else (out, None)

    off, off_events = run("cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        on, on_events = run("cuda")
        torch.cuda.synchronize()
    kernel = _counted()
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        plain, _ = run("wavefront")
    wavefront = _counted()
    print(f"{case}: kernel {kernel}, wavefront {wavefront}")
    assert kernel == wavefront
    assert 0 < kernel[1] < kernel[0]
    if tape:
        assert kernel == _tape_counts(on_events)
        for a, b in zip(on_events, off_events):
            assert torch.equal(a, b)
    for f in FIELDS:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert int(chip_smoke.trace_lanes_differ(on, plain).sum()) == 0

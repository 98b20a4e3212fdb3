"""The readers of the program's own spans and counters
(``cpmbench/metrics/_program.py`` and the metrics that use it), on the
CPU:

- the attribution of idle stretches to program spans on a synthetic trace
  whose answer is known;
- no program span reaches the profiler's records, so none can fill an
  idle stretch of ``DeviceTrace`` or appear in its ``top_ops``;
- the program's trace counters equal the reference's counted work;
- every reader gives no reading, without raising, where the program has no
  recorder (the parent of the change that added it).
"""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpmbench.harness.cell import Run
from cpmbench.harness.devtrace import DeviceTrace, _records
from cpmbench.harness.registry import Registry
from cpmbench.metrics import _program
from cpmbench.tests.conftest import ROOT

NEW = ("importance_idle_ms.edit", "render_idle_ms.frame",
       "trace_idle_ms.refine", "host_wait_ms.frame",
       "trace_accept_pct.refine")


def _run(trace=None, counts=None, interactions=2):
    return Run(device=torch.device("cpu"), cfg={}, setup_s=0.0,
               latencies_s=[0.1] * interactions, window_s=1.0,
               counts={"interactions": interactions, **(counts or {})},
               trace=trace)


def test_idle_stretches_go_to_the_innermost_span_and_its_layers():
    # Spans (ns): an edit's grid with a read inside it, then a render
    # with a scan; device busy (us) at [0, 10], [30, 40], [70, 100].
    spans = [
        ("importance.tf_change_grid", -1, 5_000, 35_000),
        ("wait.importance.tf_points", 0, 12_000, 18_000),
        ("pipeline.render_state", -1, 45_000, 110_000),
        ("render.sweep", 2, 46_000, 109_000),
        ("render.scan", 3, 60_000, 65_000),
        ("open.span", -1, 1_000, None),
    ]
    device = [(0.0, 10.0), (30.0, 40.0), (70.0, 100.0)]
    got = _program.attribute(spans, device, (0.0, 120.0))
    # Gaps: [10, 30] starts in the grid (no read open yet): grid;
    # [40, 70] starts where no span is open; [100, 120] in the sweep.
    assert got["idle_s"] == pytest.approx(70e-6)
    assert got["by_stage"] == pytest.approx({
        "importance.tf_change_grid": 20e-6, "no span": 30e-6,
        "render.sweep": 20e-6})
    assert got["by_layer"] == pytest.approx({
        "importance": 20e-6, "render": 20e-6, "pipeline": 20e-6})
    # A stretch that starts inside a wait counts for the wait and for
    # every layer around it.
    got = _program.attribute(spans, [(0.0, 13.0), (20.0, 120.0)],
                             (0.0, 120.0))
    assert got["by_stage"] == pytest.approx(
        {"wait.importance.tf_points": 7e-6})
    assert got["by_layer"] == pytest.approx(
        {"wait": 7e-6, "importance": 7e-6})


def test_the_readers_read_the_attribution_and_the_counters(monkeypatch):
    snap = {"spans": [("importance.path", -1, 0, 40_000),
                      ("wait.step.n_remaining", 0, 10_000, 30_000),
                      ("render.warp", -1, 50_000, 90_000),
                      ("trace.launch", -1, 95_000, 99_000)],
            "counters": {"wait.step.n_remaining": 1,
                         "trace.tentative_collisions": 400,
                         "trace.accepted_collisions": 100},
            "launches": {}}
    monkeypatch.setattr(_program, "snapshot", lambda: snap)
    trace = DeviceTrace(window=(0.0, 100.0),
                        device=[("k", 5.0, 20.0), ("k", 60.0, 96.0)])
    run = _run(trace, {"edits": 2, "passes": 4})
    reg = Registry(ROOT)
    for name in ("host_wait_ms.frame", "trace_accept_pct.refine"):
        monkeypatch.setattr(reg.module("metrics", name), "snapshot",
                            lambda: snap)
    read = {name: reg.reader(name)(run) for name in NEW}
    # Idle: [0, 5] in the path importance, [20, 60] in the wait (under
    # importance too), [96, 100] in the launch (trace).
    assert read["importance_idle_ms.edit"] == pytest.approx(45e-3 / 2)
    assert read["render_idle_ms.frame"] is None
    assert read["trace_idle_ms.refine"] == pytest.approx(4e-3 / 4)
    assert read["host_wait_ms.frame"] == pytest.approx(20e-3 / 2)
    assert read["trace_accept_pct.refine"] == pytest.approx(25.0)


def test_every_reader_reads_nothing_without_the_programs_recorder(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "cpm_tpu_torch.core.telemetry", None)
    _program._cache.clear()
    reg = Registry(ROOT)
    trace = DeviceTrace(window=(0.0, 100.0), device=[("k", 5.0, 20.0)])
    for name in NEW:
        assert reg.reader(name)(_run(trace, {"edits": 1, "passes": 1})) \
            is None, name
        assert reg.reader(name)(_run()) is None, name


def _small_frame():
    from cpm_tpu_torch.core.camera import Camera
    from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                           TracerConfig)
    from cpm_tpu_torch.core.lights import Light
    from cpm_tpu_torch.core.scene import Scene
    from cpm_tpu_torch.core.types import TransferFunction, Volume
    from cpm_tpu_torch.io import synthetic
    from cpm_tpu_torch.pipeline import step
    vol = Volume.from_data(synthetic.smoke_cloud(16, seed=2), device="cpu")
    scene = Scene.create(
        vol, TransferFunction.from_points(*synthetic.default_tf_points(),
                                          device="cpu"),
        TransferFunction.from_points(*synthetic.default_scattering_points(),
                                     device="cpu"),
        [Light.directional((0.0, -1.0, 0.3))], Camera.create(device="cpu"))
    config = PipelineConfig(
        photons_x=16, photons_y=16,
        tracer=TracerConfig(max_interactions=2, max_steps=300),
        render=RenderConfig(width=16, height=16))
    return scene, config, step


def test_no_program_span_reaches_the_device_trace():
    from cpm_tpu_torch.core import telemetry
    torch.set_num_threads(2)
    scene, config, step = _small_frame()
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = step.full_trace_step(scene, step.init_state(scene, config),
                                     config)
        step.render_state(scene, state, config)
    names = {s[0] for s in telemetry.snapshot()["spans"]}
    telemetry.reset()
    assert {"pipeline.full_trace_step", "trace.photons",
            "render.sweep"} <= names
    records = _records(prof)
    assert records
    assert not names & {r[0] for r in records}
    trace = DeviceTrace(window=(records[0][2], records[-1][3]),
                        device=[(n, s, e) for n, dev, s, e in records
                                if dev])
    assert not names & {n for n, _ in trace.top_ops(k=10 ** 6)}


def test_the_programs_trace_counters_equal_the_references_work():
    """The wavefront loop's tentative and accepted collisions against
    what the reference's trace counts (its tests and interactions) on the
    same small scene."""
    from cpm_tpu_torch.core import telemetry
    from cpm_tpu_torch.ops import tracer
    from cpmbench.reference import config as RC
    from cpmbench.reference import tracer as rtracer
    from cpmbench.reference import types as RT
    torch.set_num_threads(2)
    scene, config, step = _small_frame()
    samples = step.init_state(scene, config).light_samples
    tcfg = config.tracer
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tracer.trace_photons(scene.volume, scene.tf, scene.tf_scattering,
                             samples, (3, 8), tcfg)
    counted = telemetry.snapshot()["counters"]
    telemetry.reset()
    ref_tf = RT.TransferFunction.from_points(
        scene.tf.positions, scene.tf.colors, device="cpu")
    ref_tfs = RT.TransferFunction.from_points(
        scene.tf_scattering.positions, scene.tf_scattering.colors,
        device="cpu")
    ref_samples = RT.LightSamples(
        origins=samples.origins, directions=samples.directions,
        powers=samples.powers, tspan=samples.tspan,
        iteration=samples.iteration)
    _, work = rtracer.trace_photons(
        RT.Volume.from_data(scene.volume.data, device="cpu"), ref_tf,
        ref_tfs, ref_samples, (3, 8),
        RC.TracerConfig(max_interactions=tcfg.max_interactions,
                        max_steps=tcfg.max_steps), counts=True)
    assert counted["trace.tentative_collisions"] == work["tests"]
    assert counted["trace.accepted_collisions"] == work["interactions"]
    assert 0 < work["interactions"] < work["tests"]


def test_the_new_metrics_are_appended_to_the_benchmark():
    reg = Registry(ROOT)
    names = [m["name"] for m in reg.bench["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for entry in reg.bench["per_layer"][-len(NEW):]:
        for w in entry["workloads"]:
            assert entry["moves"] in {
                m["name"] for m in reg.metrics(w, traced=False)}
        assert isinstance(reg.module("metrics", entry["name"]),
                          types.ModuleType)

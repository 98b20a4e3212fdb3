"""The reader of ``render_replay_pct.frame``
(``cpmbench/metrics/render_replay_pct.frame.py``) on the CPU: the share of
replays among the renders the program's graph counters count, no reading
where the program has no such counters (the parent of the change that
added them) or rendered nothing on the card, and no reading without the
program's recorder."""

import sys

import pytest
import torch

from cpmbench.harness.cell import Run
from cpmbench.harness.registry import Registry
from cpmbench.tests.conftest import ROOT

NAME = "render_replay_pct.frame"


def _run():
    return Run(device=torch.device("cpu"), cfg={}, setup_s=0.0,
               latencies_s=[0.1], window_s=1.0,
               counts={"interactions": 1})


def _read(monkeypatch, counters):
    reg = Registry(ROOT)
    module = reg.module("metrics", NAME)
    snap = {"spans": [("render.sweep", -1, 0, 10)], "counters": counters,
            "launches": {}}
    monkeypatch.setattr(module, "snapshot", lambda: snap)
    return reg.reader(NAME)(_run())


@pytest.mark.parametrize("counters,want", [
    ({"render.graph_replays": 997, "render.graph_captures": 1,
      "render.graph_eager": 2}, 99.7),
    ({"render.graph_replays": 3}, 100.0),
    ({"render.graph_eager": 4, "wait.camera.create": 4}, 0.0),
    ({"render.graph_captures": 1, "render.graph_eager": 1,
      "render.graph_replays": 2, "trace.accepted_collisions": 9}, 50.0),
])
def test_the_share_of_replays_among_the_renders(monkeypatch, counters,
                                                want):
    assert _read(monkeypatch, counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {},  # a program without the graph counters
    {"wait.camera.host": 3, "wait.render.z_base": 1},
    {"render.graph_replays": 0, "render.graph_eager": 0},
])
def test_no_reading_without_a_render_on_the_card(monkeypatch, counters):
    assert _read(monkeypatch, counters) is None


def test_no_reading_without_the_programs_recorder(monkeypatch):
    from cpmbench.metrics import _program
    monkeypatch.setitem(sys.modules, "cpm_tpu_torch.core.telemetry", None)
    assert _program.snapshot() is None
    assert Registry(ROOT).reader(NAME)(_run()) is None


def test_the_metric_is_a_render_metric_of_the_frame_cells():
    reg = Registry(ROOT)
    (entry,) = [m for m in reg.bench["per_layer"] if m["name"] == NAME]
    assert reg.bench["per_layer"][-1] is entry
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["moves"] == "frame_ms_p95"
    assert entry["workloads"] == ["cfg5-tf-edit", "cfg3-orbit"]
    layers = {m["layer"] for m in reg.bench["per_layer"]
              if m["name"].startswith("render_")}
    assert layers == {entry["layer"]}

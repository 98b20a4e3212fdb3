"""A configuration, a traffic mix, a limits file and a per-layer metric
added as new files and new ``BENCHMARK.json`` entries alone: the harness
finds them by name and runs the new cell, and no file that was there
changes."""

import json
import shutil
from pathlib import Path

import pytest

from cpmbench.harness.registry import Registry
from cpmbench.tests.conftest import ROOT, run_small

METRIC = '''"""tiny_retraces.edit: retraces per interaction."""


def read(run):
    return run.count("retraces") / run.interactions
'''

# A step no mix had: the dispatcher with the light dirty.
OP = '''"""light_dirty: the dispatcher with the lights marked dirty, a full
retrace; checked against the reference's full trace."""

from cpmbench.harness.check import lanes_differ, rel_err


def program(side, scene, state):
    return side.step.step(scene, state, side.config, side.flags(light=True))


def reference(side, scene, state):
    return side.full_trace_step(scene, state)


def run(s, step, ctx, record):
    s.state = s.on(program, reference)(s.scene, s.state)
    s.counts["retraces"] += 1
    if record is not None:
        record.steps.append(("light_dirty", {"after": s.state}))


def check(c, f):
    want = c.full_trace()
    c.note("photons_differ", lanes_differ(f["after"].photons, want.photons))
    c.note("light_volume_err", rel_err(f["after"].light_volume,
                                       want.light_volume))
'''

# A light type no configuration had, with the reference's emission of it.
LIGHT = '''"""A point light: {"type": "point", "position": [x, y, z]}."""

import math

import torch

from cpmbench.reference import intersect
from cpmbench.reference.types import LightSamples


class PointLight:
    type = "point"

    def __init__(self, position, radiance):
        self.position, self.radiance = tuple(position), tuple(radiance)

    def emit(self, samples, key=None, box_min=0.0, box_max=1.0,
             iteration=0):
        """Uniform sphere directions from (u, v); power = radiance / pdf."""
        dev = samples.device
        u, v = samples[:, 0], samples[:, 1]
        z = 1.0 - 2.0 * u
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * v
        directions = -torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                                   z], dim=-1)
        pdf = 1.0 / (4.0 * math.pi)
        powers = (torch.tensor(self.radiance, dtype=torch.float32,
                               device=dev) / pdf).expand(directions.shape)
        origins = torch.tensor(self.position, dtype=torch.float32,
                               device=dev).expand(directions.shape)
        origins = origins.contiguous()
        tspan = intersect.light_sample_box_intersection(
            origins, directions, box_min, box_max)
        return LightSamples(origins=origins, directions=directions,
                            powers=powers.contiguous(), tspan=tspan,
                            iteration=int(iteration))


def program(Light, spec):
    return Light.point(spec["position"])


def reference(Light, spec):
    return PointLight(spec["position"], (1.0, 1.0, 1.0))
'''

# A volume kind no configuration had.
VOLUME = '''"""A noisy ball: {"kind": "tiny_ball", "dim": D}."""

import torch


def make(spec, generator, device):
    d = spec["dim"]
    t = (torch.arange(d, dtype=torch.float32, device=device) + 0.5) / d
    r = torch.sqrt((t[:, None, None] - 0.5) ** 2 + (t[None, :, None] - 0.5)
                   ** 2 + (t[None, None, :] - 0.5) ** 2)
    noise = torch.rand((d, d, d), generator=generator, device=device)
    return torch.clamp(1.0 - 2.5 * r, 0.0, 1.0) * (0.5 + 0.5 * noise)
'''


@pytest.fixture
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cpmbench", tmp_path / "cpmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def snapshot(root):
    return {p.relative_to(root): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_and_entries_make_a_new_cell(copy):
    """A new configuration (a new volume kind, a point light), a new mix
    of a new step, its limits and a new metric."""
    before = snapshot(copy)
    cb = copy / "cpmbench"
    for kind, name, text in (("ops", "light_dirty", OP),
                             ("lights", "point", LIGHT),
                             ("data", "tiny_ball", VOLUME),
                             ("metrics", "tiny_retraces.edit", METRIC)):
        assert not (cb / kind / f"{name}.py").exists()
        (cb / kind / f"{name}.py").write_text(text)
    cfg = json.loads((cb / "configs" / "cfg3-ct256-guided.json").read_text())
    cfg.update(name="tiny-ball", guided_emission=False,
               volume={"kind": "tiny_ball", "dim": 16},
               lights=[{"type": "point", "position": [0.5, 1.4, 0.4]}])
    (cb / "configs" / "tiny-ball.json").write_text(json.dumps(cfg))
    mix = {"loop": "closed", "unit": "frame", "warmup": 1, "sample": 1,
           "steps": [{"op": "light_dirty"}, {"op": "render"}]}
    (cb / "traffic" / "tiny_relight.json").write_text(json.dumps(mix))
    (cb / "limits" / "tiny-cell.json").write_text(json.dumps(
        {"limits": {"photons_differ": 0.0, "light_volume_err": 0.0,
                    "image_err": 0.0}}))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-ball", "source": "a test",
                             "file": "cpmbench/configs/tiny-ball.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-ball",
                               "traffic": "tiny_relight", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0].setdefault("workloads", []).append("tiny-cell")
    bench["per_layer"].append({
        "name": "tiny_retraces.edit", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "Entry", "moves":
        bench["end_to_end"][0]["name"], "workloads": ["tiny-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    reg = Registry(copy)
    assert reg.workload("tiny-cell")["config"] == "tiny-ball"
    assert reg.config("tiny-ball")["name"] == "tiny-ball"
    assert reg.traffic("tiny_relight")["steps"][0]["op"] == "light_dirty"
    assert [m["name"] for m in reg.metrics("tiny-cell", True)] == [
        "tiny_retraces.edit"]
    result = run_small("tiny-cell", root=copy,
                       cfg={"volume": {"kind": "tiny_ball", "dim": 16}})
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert bench["end_to_end"][0]["name"] in result["metrics"]
    after = snapshot(copy)
    changed = [p for p, b in before.items() if after.get(p) != b]
    assert changed == [Path("BENCHMARK.json")]


def test_the_new_step_is_checked(copy, monkeypatch):
    """The new cell's check holds the point light's emission: a program
    whose point light sits elsewhere is not correct."""
    test_new_files_and_entries_make_a_new_cell(copy)
    from cpm_tpu_torch.core.lights import Light
    point = Light.point
    monkeypatch.setattr(Light, "point", staticmethod(
        lambda position, radiance=(1.0, 1.0, 1.0): point(
            [position[0] + 0.01, *position[1:]], radiance)))
    r = run_small("tiny-cell", root=copy,
                  cfg={"volume": {"kind": "tiny_ball", "dim": 16}})
    assert not r["correct"], r["checks"]


def test_a_dispatched_tf_edit_is_a_mix_alone(copy):
    """A TF edit through the dispatcher, ``step(DirtyFlags(tf=True))``
    with the edit's importance grid (a correlated batch of a fresh round,
    ``correlated_step``), is a new mix file and entries alone; its check
    holds the batch and the light volume's drift."""
    cb = copy / "cpmbench"
    mix = {"loop": "closed", "unit": "frame", "warmup": 1, "sample": 1,
           "steps": [{"op": "edit_tf", "opacity_factor": [1.2, 1.5],
                      "alternate": "reciprocal", "move_interior": 0.03},
                     {"op": "tf_change_importance"},
                     {"op": "step", "dirty": ["tf"]},
                     {"op": "render"}]}
    (cb / "traffic" / "tiny_dispatched_edit.json").write_text(
        json.dumps(mix))
    (cb / "limits" / "tiny-edit.json").write_text(json.dumps(
        {"limits": {"photons_differ": 0.0, "light_volume_err": 1e-6,
                    "image_err": 1e-6, "drift_err": 1e-6}}))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-edit",
                               "config": "cfg5-512-2light",
                               "traffic": "tiny_dispatched_edit",
                               "chips": 1, "why": "a test"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    from cpmbench.tests.conftest import small
    r = run_small("tiny-edit", root=copy, cfg=small("cfg5-tf-edit"))
    assert r["correct"], r["checks"]
    assert r["checks"]["photons_differ"]["value"] == 0.0


def test_every_named_piece_has_its_file():
    reg = Registry()
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        assert callable(reg.volume(cfg["volume"]["kind"]).make)
        for light in cfg["lights"]:
            mod = reg.light(light["type"])
            assert callable(mod.program) and callable(mod.reference)
        for step in reg.traffic(w["traffic"])["steps"]:
            assert callable(reg.op(step["op"]).run)
        assert reg.limits(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in reg.bench[kind]:
            assert callable(reg.reader(m["name"]))


def test_unknown_names_are_refused(copy):
    reg = Registry(copy)
    with pytest.raises(KeyError):
        reg.workload("no-such-cell")
    with pytest.raises(FileNotFoundError):
        reg.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such.metric")
    with pytest.raises(FileNotFoundError):
        reg.op("no_such_step")
    with pytest.raises(FileNotFoundError):
        reg.light("no_such_light")

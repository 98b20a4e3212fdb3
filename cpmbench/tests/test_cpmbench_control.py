"""The comparison fails what it should: the controls (the reference in the
program's place with its matrix products in TF32, or stored in bfloat16)
and, with the timed path broken
underneath a run, each fault a cell can have: a step that returns its state
unchanged, half of the batch left out with the rest weighted double, and an
answer (the image) altered where it is produced. One chip has no exchange
between chips to leave out. A camera step that returns its state unchanged
is no fault in the orbit cell: its photons do not depend on the camera."""

import dataclasses
import functools

import pytest
import torch

from cpmbench.harness.backends import ReferenceBackend
from cpmbench.reference.pipeline import CONTROLS
from cpmbench.tests.conftest import WORKLOADS, run_small


def control(name: str):
    return functools.partial(ReferenceBackend, precision=CONTROLS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTROLS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, name, card):
    """On the card: the CPU has no TF32 products."""
    r = run_small(workload, device=card, side=control(name))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_bfloat16_control_is_not_correct_on_the_cpu(workload):
    r = run_small(workload, side=control("bfloat16"))
    assert not r["correct"], r["checks"]


def unchanged(fn):
    def step(scene, state, *args, **kwargs):
        return state
    return step


def half_batch(fn):
    """The trace of the first half of the lanes only, the second half's
    photons left unused and the first half's powers doubled."""
    def trace(volume, tf, tfs, samples, key, config, *args, **kwargs):
        out = fn(volume, tf, tfs, samples, key, config, *args, **kwargs)
        half = out.positions.shape[1] // 2
        pos, pw = out.positions.clone(), out.powers.clone()
        pos[:, half:] = float("inf")
        pw[:, half:] = 0.0
        pw[:, :half] *= 2.0
        return dataclasses.replace(out, positions=pos, powers=pw)
    return trace


def altered_image(fn):
    def render(*args, **kwargs):
        return fn(*args, **kwargs) * 1.01
    return render


FAULTS = [
    ("cfg5-tf-edit", "pipeline.step", "correlated_step_scalable", unchanged),
    ("cfg5-refine", "pipeline.step", "progressive_step", unchanged),
    ("cfg5-tf-edit", "ops.tracer", "trace_photons", half_batch),
    ("cfg3-orbit", "ops.tracer", "trace_photons", half_batch),
    ("cfg5-refine", "ops.tracer", "trace_photons", half_batch),
    ("cfg5-tf-edit", "pipeline.step", "render_state", altered_image),
    ("cfg3-orbit", "pipeline.step", "render_state", altered_image),
    ("cfg5-refine", "pipeline.step", "render_state", altered_image),
]


@pytest.mark.parametrize("workload,module,attr,fault", FAULTS,
                         ids=[f"{w}-{a}-{f.__name__}"
                              for w, _, a, f in FAULTS])
def test_planted_fault_is_not_correct(monkeypatch, workload, module, attr,
                                      fault):
    mod = __import__(f"cpm_tpu_torch.{module}", fromlist=[attr])
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    torch.manual_seed(0)
    r = run_small(workload)
    assert not r["correct"], r["checks"]


def test_drift_outside_the_sample_is_not_correct(monkeypatch):
    """A correlated batch that updates the light volume wrongly where the
    check does not sample it (here in the warm-up) still fails: the last
    state's light volume is held against the splat of the last photon
    map, while the sampled batch alone reads sound."""
    from cpm_tpu_torch.ops import splat
    fn, calls = splat.splat_selected, []

    def wrong_first_batch(*args, **kwargs):
        calls.append(1)
        out = fn(*args, **kwargs)
        return out * 1.01 if len(calls) <= 2 else out
    monkeypatch.setattr(splat, "splat_selected", wrong_first_batch)
    r = run_small("cfg5-tf-edit", mix={"warmup": 2})
    c = r["checks"]
    assert c["light_volume_err"]["value"] <= c["light_volume_err"]["limit"]
    assert c["drift_err"]["value"] > c["drift_err"]["limit"], c
    assert not r["correct"]

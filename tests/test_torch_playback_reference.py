"""The port's time-varying playback against the benchmark's plain reference
(``cpmbench/reference/timevarying.py``), on the CPU at a small size: a
24^3 x 6-step orbiting sphere (``cpmbench/data/orbiting_sphere.py``, the
port's ``io/synthetic.time_varying_sequence``), 32^2 photons.

- the volume at a playback time, bit for bit, at fractional and integer
  times and across the wrap from the last step to the first;
- the difference grids and min/max grids, bit for bit, with partial cells
  at 20^3, and the reference's grids against a per-cell numpy loop;
- the time-varying importance grid, bit for bit;
- one ``advance_time``: the selected photons bit for bit, the photons
  bit-equal in >= 99.9% of lanes, the light volume to a stated tolerance;
- the reference loads nothing of the program, the JAX package or JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cpmbench.data import orbiting_sphere
from cpmbench.harness.backends import ProgramBackend, ReferenceBackend
from cpmbench.harness.check import lanes_differ, rel_err
from cpmbench.harness.registry import Registry
from cpmbench.reference import timevarying as R
from cpm_tpu_torch.io import synthetic
from cpm_tpu_torch.ops import importance as timportance
from cpm_tpu_torch.ops import mixer
from cpm_tpu_torch.ops import select as tselect
from cpm_tpu_torch.pipeline import timevarying as tv

DIM, STEPS, CELL = 24, 6, 8
# The share of lanes whose photons may differ in any bit: the port's bar
# (the trace bit-equal in >= 99.9% of lanes), the cell's limit.
PHOTONS_DIFFER = 1e-3
# max |port - reference| / max |reference| of the light volume after one
# step: the port splats the signed list of the removed and the added
# deposits at once, the reference each list apart, so the same float32
# terms are summed in another order: a few ulps of the peak.
LIGHT_VOLUME_REL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def sequence(dim=DIM, steps=STEPS):
    return orbiting_sphere.sequence({"dim": dim, "steps": steps}, None,
                                    "cpu")


@pytest.mark.parametrize("dim,steps", [(DIM, STEPS), (20, 5)])
def test_the_sequence_is_the_ports_synthetic_one(dim, steps):
    got = sequence(dim, steps)
    want = synthetic.time_varying_sequence(dim, steps)
    assert torch.equal(got, torch.from_numpy(want))
    assert torch.equal(orbiting_sphere.make({"dim": dim, "steps": steps},
                                            None, "cpu"), got[0])


@pytest.mark.parametrize("time", [0.0, 1.0, 2.37, 3.5, 5.0, 5.6, 5.999,
                                  11.25])
def test_the_volume_at_a_time_is_the_references(time):
    """5.6 and 5.999 mix step 5 with step 0; 11.25 is step 5 and 0 of the
    next cycle; at integer times the step itself."""
    v = sequence()
    got = mixer.sequence_sample(v, time)
    assert torch.equal(got, R.sequence_sample(v, time))
    if time == int(time):
        assert torch.equal(got, v[int(time) % STEPS])


def cell_means_oracle(volumes: np.ndarray, cell: int) -> np.ndarray:
    """Per cell, from voxel 0, the float64 mean of |v_{t+1 mod T} - v_t|
    over the cell's real voxels."""
    diff = np.abs(np.roll(volumes, -1, 0).astype(np.float64) - volumes)
    t, d, h, w = volumes.shape
    g = [-(-n // cell) for n in (d, h, w)]
    out = np.zeros((t, *g))
    for z in range(g[0]):
        for y in range(g[1]):
            for x in range(g[2]):
                out[:, z, y, x] = diff[:, z * cell:(z + 1) * cell,
                                       y * cell:(y + 1) * cell,
                                       x * cell:(x + 1) * cell].mean((1, 2, 3))
    return out


@pytest.mark.parametrize("dim", [DIM, 20])
def test_the_sequences_analysis_is_the_references(dim):
    """At 20^3 the last cell of each axis holds 4 voxels."""
    v = sequence(dim)
    port = tv.VolumeSequence.prepare(v, CELL, device="cpu")
    ref = R.prepare(v, CELL)
    assert torch.equal(port.diff, ref.diff)
    assert torch.equal(port.minmax, ref.minmax)
    np.testing.assert_allclose(ref.diff.numpy(),
                               cell_means_oracle(v.numpy(), CELL),
                               rtol=1e-6, atol=1e-9)


def tf():
    pos, col = synthetic.default_tf_points()
    return (torch.tensor(pos, dtype=torch.float32),
            torch.tensor(col, dtype=torch.float32))


@pytest.mark.parametrize("time", [0.4, 2.0, 5.5])
def test_the_time_varying_grid_is_the_references(time):
    v = sequence()
    port = tv.VolumeSequence.prepare(v, CELL, device="cpu")
    ref = R.prepare(v, CELL)
    w = timportance.ImportanceWeights().normalized()
    got = tv.time_step_importance(port.minmax, port.diff, time, *tf(),
                                  tuple(v.shape[1:]), CELL, w)
    want = R.time_varying_importance(ref, time, *tf(), w)
    assert torch.equal(got.data, want.data)
    assert torch.equal(got.cell_dim, want.cell_dim)
    assert torch.equal(got.volume_dim, want.volume_dim)
    assert float(got.data.max()) > 0.0


CFG = {
    "volume": {"kind": "orbiting_sphere", "dim": DIM, "steps": STEPS},
    "tf": {"positions": [0.0, 0.1, 0.5, 1.0],
           "colors": [[0.0, 0.0, 0.0, 0.0], [0.2, 0.3, 0.9, 0.02],
                      [0.9, 0.6, 0.2, 0.3], [1.0, 1.0, 1.0, 0.8]]},
    "scattering_albedo": 0.9,
    "lights": [{"type": "directional", "direction": [0.0, -1.0, 0.3]}],
    "photons_x": 32, "photons_y": 32, "max_interactions": 4,
    "max_steps": 6000, "image": {"width": 32, "height": 32},
    "camera": {"eye": [0.5, 0.5, -1.5], "center": [0.5, 0.5, 0.5],
               "up": [0.0, 1.0, 0.0], "fov_y": 45.0},
    "recompute": {"max_photons_fraction": 0.1,
                  "importance_quadrature_samples": 8, "grid_cell_size": 8},
}


def test_one_advance_time_is_the_references(monkeypatch):
    reg = Registry()
    v = sequence()
    port, ref = ProgramBackend(CFG, "cpu", reg), ReferenceBackend(
        CFG, "cpu", reg)
    scene = port.scene(v[0], CFG["camera"])
    state = port.full_trace_step(scene, port.init_state(scene, 11))
    seq = tv.VolumeSequence.prepare(v, CELL, device="cpu")
    picked = []

    def spy(imp, budget, exclude=None):
        out = select_fn(imp, budget, exclude=exclude)
        picked.append(out)
        return out
    select_fn = tselect.select_photons_to_recompute
    monkeypatch.setattr(tselect, "select_photons_to_recompute", spy)
    time = 2.6
    _, after = tv.advance_time(scene, state, seq, time, port.config)

    rscene = ref.scene(v[0], CFG["camera"])
    start = ref.init_state(rscene, 11)
    _, out = R.advance_time(rscene, start.light_samples, start.key,
                            ref.config, state.photons, state.light_volume,
                            R.prepare(v, CELL), time)
    (indices, valid, _), = picked
    assert torch.equal(valid, out["valid"])
    assert torch.equal(indices[valid], out["indices"][out["valid"]])
    assert int(valid.sum()) > 0
    assert lanes_differ(after.photons, out["photons"]) <= PHOTONS_DIFFER
    assert lanes_differ(state.photons, out["photons"]) > PHOTONS_DIFFER
    assert rel_err(after.light_volume, out["light_volume"]) <= \
        LIGHT_VOLUME_REL
    moved = rel_err(state.light_volume, out["light_volume"])
    assert moved > 100 * LIGHT_VOLUME_REL
    assert dataclasses.is_dataclass(after)


def test_the_reference_loads_nothing_of_the_program_or_jax():
    from cpmbench.tests.test_cpmbench_imports import loaded
    names = loaded(["cpmbench.reference.timevarying"])
    assert "cpmbench" in names
    assert not names & {"cpm_tpu_torch", "cpm_tpu", "jax", "jaxlib", "flax"}

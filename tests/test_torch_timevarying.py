"""The port's time-varying playback against the JAX reference and against
its own semantics (CPU; the reference's tests/test_timevarying.py setup:
a 48^3 x 24-step orbiting sphere, 32^2 photons, 2 interactions):

- ``sequence_min_max``, ``volume_difference_grids``, ``mix``,
  ``sequence_sample`` and ``time_step_importance`` on shared numpy inputs,
  and the two grids at a side that is not a multiple of the cell size
  against a numpy oracle whose cells start at voxel 0;
- ``advance_time`` from a state of the reference carried over by
  ``io/convert.py``;
- the five behaviours of tests/test_timevarying.py, re-stated on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import camera as jcamera
from cpm_tpu.core import lights as jlights
from cpm_tpu.core import scene as jscene
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import PipelineConfig as JPipelineConfig
from cpm_tpu.core.config import RecomputeConfig as JRecomputeConfig
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import SplatConfig as JSplatConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import diffanalysis as jdiff
from cpm_tpu.ops import minmax as jminmax
from cpm_tpu.ops import mixer as jmixer
from cpm_tpu.ops import importance as jimportance
from cpm_tpu.ops import select as jselect
from cpm_tpu.pipeline import step as jstep
from cpm_tpu.pipeline import timevarying as jtv
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       RenderConfig, SplatConfig,
                                       TracerConfig)
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import diffanalysis as tdiff
from cpm_tpu_torch.ops import minmax as tminmax
from cpm_tpu_torch.ops import mixer as tmixer
from cpm_tpu_torch.ops import importance as timportance
from cpm_tpu_torch.ops import select as tselect
from cpm_tpu_torch.pipeline import step as tstep
from cpm_tpu_torch.pipeline import timevarying as ttv

DIM, STEPS = 48, 24
# Per-cell means of |v_{t+1} - v_t| summed in another order.
DIFF_RTOL, DIFF_ATOL = 1e-6, 1e-7
MIX_RTOL = 1e-6
IMPORTANCE_RTOL, IMPORTANCE_ATOL = 1e-5, 1e-7
# A whole step from the same state: relative L1 of the light volume.
STEP_REL_L1 = 1e-2
# The reference's own bounds (tests/test_timevarying.py:88-89, :97).
TRACKS_REL_L1, STALE_REL_L1 = 1e-3, 1.0

TF_POINTS = ([0.0, 0.3, 0.32, 1.0],
             [[0.2, 0.2, 0.2, 0.0], [0.2, 0.2, 0.2, 0.0],
              [0.9, 0.8, 0.7, 0.5], [1.0, 1.0, 1.0, 0.8]])
TRACER = dict(max_interactions=2, max_steps=1500)


def leaves_of(tree) -> dict:
    """A reference pytree as {field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).sum() / (np.abs(want).sum() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _configs(frac=1.0, **recompute):
    kw = dict(photons_x=32, photons_y=32)
    jcfg = JPipelineConfig(
        tracer=JTracerConfig(use_compaction=False, **TRACER),
        recompute=JRecomputeConfig(max_photons_fraction=frac, **recompute),
        splat=JSplatConfig(volume_size_from_radius=False, volume_dim=16),
        render=JRenderConfig(width=24, height=24), **kw)
    tcfg = PipelineConfig(
        tracer=TracerConfig(**TRACER),
        recompute=RecomputeConfig(max_photons_fraction=frac, **recompute),
        splat=SplatConfig(volume_size_from_radius=False, volume_dim=16),
        render=RenderConfig(width=24, height=24), **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's small eager ops run fastest on one thread here: beside
    JAX's own thread pool, torch's pool costs ~8x on these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def volumes():
    return synthetic.time_varying_sequence(DIM, STEPS)


@pytest.fixture(scope="module")
def seqs(volumes):
    return (jtv.VolumeSequence.prepare(volumes, cell_size=8),
            ttv.VolumeSequence.prepare(volumes, cell_size=8, device="cpu"))


@pytest.fixture(scope="module")
def shared(volumes):
    """The reference's scene and its state after a full trace, and both
    carried over to the port."""
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(volumes[0]),
        jtypes.TransferFunction.from_points(*TF_POINTS),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create())
    jcfg, _ = _configs()
    state = jstep.full_trace_step(scene, jstep.init_state(scene, jcfg), jcfg)
    tscene = convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                      device="cpu")
    tstate = convert.state_from_numpy(leaves_of(state), device="cpu")
    return scene, state, tscene, tstate


@pytest.fixture(scope="module")
def traced(shared):
    """The port's own scene and state after its own full trace."""
    _, _, tscene, _ = shared
    _, tcfg = _configs()
    state = tstep.full_trace_step(tscene, tstep.init_state(tscene, tcfg),
                                  tcfg)
    return tscene, state


@pytest.fixture(scope="module")
def full_lvs(traced, seqs):
    """The light volumes of full retraces at t = 1..4 from that state."""
    tscene, state = traced
    _, tcfg = _configs()
    out = {}
    for t in range(1, 5):
        scene_t = _at(tscene, seqs[1].volumes[t])
        out[t] = tstep.full_trace_step(scene_t, state, tcfg).light_volume
    return out


def _at(scene, data):
    return dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, data=data))


def _ones(n_cells, dim):
    return ttypes.UniformGrid3D(
        data=torch.ones((n_cells,) * 3), cell_dim=torch.full((3,), 8.0),
        volume_dim=torch.full((3,), float(dim)))


# --- the sequence analysis ---------------------------------------------------


SHAPES = {"16^3 x 3": (3, 16, 16, 16), "24x32x16 x 2": (2, 24, 32, 16),
          "8x8x40 x 4": (4, 8, 8, 40)}


def _random_sequence(shape, seed):
    rs = np.random.default_rng(seed)
    seq = rs.random(shape, dtype=np.float32)
    seq[:, : shape[1] // 2] *= 0.25  # some cells change little
    return seq


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_sequence_min_max_bit_exact(name):
    """At multiples of the cell size both packages' cells are the same, so
    every min and max is the same voxel value."""
    seq = _random_sequence(SHAPES[name], 1)
    want = np.asarray(jminmax.sequence_min_max(jnp.asarray(seq), 8))
    got = tminmax.sequence_min_max(torch.from_numpy(seq), 8).numpy()
    assert got.shape == want.shape == SHAPES[name][:1] + tuple(
        s // 8 for s in SHAPES[name][1:]) + (2,)
    np.testing.assert_array_equal(got, want)
    # One step alone is the volume's own min/max grid.
    one = tminmax.volume_min_max(ttypes.Volume.from_data(seq[1],
                                                         device="cpu"), 8)
    np.testing.assert_array_equal(one.data.numpy(), got[1])


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("data_range", [1.0, 0.5])
def test_volume_difference_grids_match(name, data_range):
    seq = _random_sequence(SHAPES[name], 2)
    want = np.asarray(jdiff.volume_difference_grids(jnp.asarray(seq), 8,
                                                    data_range))
    got = tdiff.volume_difference_grids(torch.from_numpy(seq), 8,
                                        data_range).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=DIFF_RTOL, atol=DIFF_ATOL)
    assert want.max() > 0.1


def _cells(n, cell):
    return [slice(s, min(s + cell, n)) for s in range(0, n, cell)]


@pytest.mark.parametrize("what", ["min_max", "difference"])
def test_partial_cells_start_at_voxel_0(what):
    """A side that is not a multiple of 8: cells start at voxel 0 and the
    last one along an axis is partial, held against a numpy oracle (the
    reference pads both ends instead, ROADMAP queue 3 item 1)."""
    seq = _random_sequence((3, 20, 13, 17), 3)
    cz, cy, cx = _cells(20, 8), _cells(13, 8), _cells(17, 8)
    want = np.zeros((3, len(cz), len(cy), len(cx), 2), np.float32)
    nxt = np.roll(seq, -1, axis=0)
    diff64 = np.abs(nxt.astype(np.float64) - seq)
    want_diff = np.zeros(want.shape[:-1])
    for i, z in enumerate(cz):
        for j, y in enumerate(cy):
            for k, x in enumerate(cx):
                block = seq[:, z, y, x].reshape(3, -1)
                want[:, i, j, k] = np.stack([block.min(1), block.max(1)], -1)
                want_diff[:, i, j, k] = diff64[:, z, y, x].reshape(
                    3, -1).mean(1)
    if what == "min_max":
        got = tminmax.sequence_min_max(torch.from_numpy(seq), 8).numpy()
        np.testing.assert_array_equal(got, want)
    else:
        got = tdiff.volume_difference_grids(torch.from_numpy(seq), 8).numpy()
        np.testing.assert_allclose(got, want_diff, rtol=DIFF_RTOL,
                                   atol=DIFF_ATOL)


@pytest.mark.parametrize("time", [0.0, 3.0, 23.0, 24.0, 26.0, -1.0, 2.5,
                                  7.25, 23.6, -0.3])
def test_mix_and_sequence_sample_match(volumes, time):
    """Cyclic indexing; an integer time gives that step exactly."""
    seq = volumes[:, 8:24]
    want = np.asarray(jmixer.sequence_sample(jnp.asarray(seq),
                                             jnp.float32(time)))
    got = tmixer.sequence_sample(torch.from_numpy(seq), time).numpy()
    if float(time).is_integer():
        np.testing.assert_array_equal(got, seq[int(time) % STEPS])
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=MIX_RTOL, atol=0.0)
    a, b = volumes[4, :4], volumes[9, :4]
    np.testing.assert_allclose(
        tmixer.mix(torch.from_numpy(a), torch.from_numpy(b), 0.3).numpy(),
        np.asarray(jmixer.mix(jnp.asarray(a), jnp.asarray(b), 0.3)),
        rtol=MIX_RTOL, atol=0.0)


def test_prepared_sequences_match(seqs):
    jseq, tseq = seqs
    assert tseq.n_steps == jseq.n_steps == STEPS
    assert tseq.volumes.dtype == torch.float32
    np.testing.assert_array_equal(tseq.minmax.numpy(), np.asarray(jseq.minmax))
    np.testing.assert_allclose(tseq.diff.numpy(), np.asarray(jseq.diff),
                               rtol=DIFF_RTOL, atol=DIFF_ATOL)


@pytest.mark.parametrize("time", [1.0, 2.5, 23.0])
def test_time_step_importance_matches(seqs, time):
    jseq, tseq = seqs
    pos, cols = TF_POINTS
    w = jimportance.ImportanceWeights(color=0.5, opacity=2.0).normalized()
    assert timportance.ImportanceWeights(
        color=0.5, opacity=2.0).normalized() == pytest.approx(w)
    want = jtv.time_step_importance(
        jseq.minmax, jseq.diff, jnp.float32(time), jnp.asarray(pos),
        jnp.asarray(cols), (DIM,) * 3, 8, w)
    got = ttv.time_step_importance(tseq.minmax, tseq.diff, time, _t(pos),
                                   _t(cols), (DIM,) * 3, 8, w)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=IMPORTANCE_RTOL, atol=IMPORTANCE_ATOL)
    np.testing.assert_array_equal(got.cell_dim.numpy(),
                                  np.asarray(want.cell_dim))
    np.testing.assert_array_equal(got.volume_dim.numpy(),
                                  np.asarray(want.volume_dim))
    flagged = float((np.asarray(want.data) > 0).mean())
    assert 0.0 < flagged < 1.0


# --- advance_time against the reference ---------------------------------------


def test_advance_time_matches_reference(shared, seqs):
    """From the reference's state: the same photons are selected (the
    budget holds every flagged photon, so the selected set does not hang
    on the last bits of the importance), the bookkeeping is equal, the
    volume swapped in is the reference's, and the light volume is within
    1% relative L1. At a fractional time: the volume is a lerp of two
    steps."""
    scene, state, tscene, tstate = shared
    jseq, tseq = seqs
    jcfg, tcfg = _configs()
    time = 2.5
    grid_j = jtv.time_step_importance(
        jseq.minmax, jseq.diff, jnp.float32(time), scene.tf.positions,
        scene.tf.colors, (DIM,) * 3, 8,
        jimportance.ImportanceWeights().normalized())
    grid_t = ttv.time_step_importance(
        tseq.minmax, tseq.diff, time, tscene.tf.positions, tscene.tf.colors,
        (DIM,) * 3, 8, timportance.ImportanceWeights().normalized())
    budget = tstep.recompute_budget(tcfg, 1024)
    jidx, jvalid, _ = jselect.select_photons_to_recompute(
        jstep.recompute_importance(jcfg, grid_j, state.photons,
                                   state.light_samples), budget)
    tidx, tvalid, _ = tselect.select_photons_to_recompute(
        tstep.recompute_importance(tcfg, grid_t, tstate.photons,
                                   tstate.light_samples), budget)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tidx.numpy()[tvalid.numpy()],
                                  np.asarray(jidx)[np.asarray(jvalid)])
    n_selected = int(tvalid.sum())
    assert 50 < n_selected < 1024

    jscene_t, want = jtv.advance_time(scene, state, jseq, time, jcfg)
    tscene_t, got = ttv.advance_time(tscene, tstate, tseq, time, tcfg)
    np.testing.assert_allclose(tscene_t.volume.data.numpy(),
                               np.asarray(jscene_t.volume.data),
                               rtol=MIX_RTOL, atol=0.0)
    np.testing.assert_array_equal(got.retraced.numpy(),
                                  np.asarray(want.retraced))
    assert got.n_remaining == int(want.n_remaining) == 0
    assert got.recompute_phase == int(want.recompute_phase) == 1
    # Only selected photons change, in both packages.
    selected = np.zeros(1024, bool)
    selected[tidx.numpy()[tvalid.numpy()]] = True
    tchanged = torch.any(got.photons.positions != tstate.photons.positions,
                         dim=2).any(dim=0).numpy()
    assert not tchanged[~selected].any()
    lv, want_lv = got.light_volume.numpy(), np.asarray(want.light_volume)
    moved = rel_l1(want_lv, np.asarray(state.light_volume))
    print(f"time {time}: {n_selected} photons selected, the step moved the "
          f"light volume by rel L1 {moved:.3e}; port vs reference "
          f"{rel_l1(lv, want_lv):.3e}")
    assert moved > 10 * STEP_REL_L1
    assert rel_l1(lv, want_lv) < STEP_REL_L1


def test_advance_time_full_retrace_matches_reference(shared, seqs):
    scene, state, tscene, tstate = shared
    jcfg, tcfg = _configs()
    _, want = jtv.advance_time(scene, state, seqs[0], 3.0, jcfg,
                               correlated=False)
    _, got = ttv.advance_time(tscene, tstate, seqs[1], 3.0, tcfg,
                              correlated=False)
    assert got.recompute_phase == int(want.recompute_phase) == 0
    assert rel_l1(got.light_volume.numpy(),
                  np.asarray(want.light_volume)) < STEP_REL_L1


# --- the behaviours of tests/test_timevarying.py on the port ----------------


def test_playback_tracks_full_retrace(traced, seqs, full_lvs):
    """With a budget that covers the flagged set, playback reproduces the
    full retrace (< 1e-3 relative L1 per step: unflagged photons keep their
    paths, flagged ones are retraced under their own streams) while a
    frozen map drifts by > 100%; and the flagged set is a strict subset
    (5-85%) of the photons."""
    tscene, state = traced
    tseq = seqs[1]
    _, tcfg = _configs()
    scene_c, st_c = tscene, state
    for t in range(1, 5):
        scene_c, st_c = ttv.advance_time(scene_c, st_c, tseq, float(t), tcfg)
        assert torch.equal(scene_c.volume.data, tseq.volumes[t])
        err_corr = rel_l1(st_c.light_volume, full_lvs[t])
        err_stale = rel_l1(state.light_volume, full_lvs[t])
        print(f"t={t}: correlated {err_corr:.3e}, stale {err_stale:.3e}")
        assert err_corr < TRACKS_REL_L1, (t, err_corr)
        assert err_stale > STALE_REL_L1, (t, err_stale)
    grid = ttv.time_step_importance(
        tseq.minmax, tseq.diff, 1.0, tscene.tf.positions, tscene.tf.colors,
        (DIM,) * 3, 8, timportance.ImportanceWeights().normalized())
    imp = tstep.recompute_importance(tcfg, grid, state.photons,
                                     state.light_samples)
    frac = float((imp > 0).float().mean())
    assert 0.05 < frac < 0.85, frac


def test_undersized_budget_tracks_better_than_stale(traced, seqs, full_lvs):
    """A 40% budget, smaller than the flagged set, cannot be exact, but over
    four steps it tracks the full retrace better than a frozen map."""
    tscene, state = traced
    _, tcfg = _configs(frac=0.4)
    scene_c, st_c = tscene, state
    ec, es = [], []
    for t in range(1, 5):
        scene_c, st_c = ttv.advance_time(scene_c, st_c, seqs[1], float(t),
                                         tcfg)
        assert st_c.n_remaining > 0
        ec.append(rel_l1(st_c.light_volume, full_lvs[t]))
        es.append(rel_l1(state.light_volume, full_lvs[t]))
    assert np.mean(ec) < np.mean(es), (ec, es)


def test_full_budget_grid_of_ones_bit_matches_full_retrace(traced, seqs):
    """Every photon flagged and a budget of the whole buffer: the
    correlated step retraces the full trace's photons bit for bit."""
    tscene, state = traced
    _, tcfg = _configs()
    scene3 = _at(tscene, seqs[1].volumes[3])
    st_c = tstep.correlated_step(scene3, state, tcfg, _ones(DIM // 8, DIM),
                                 budget=state.photons.n)
    st_f = tstep.full_trace_step(scene3, state, tcfg)
    for f in ("positions", "powers", "directions", "exit_power",
              "exit_direction"):
        assert torch.equal(getattr(st_c.photons, f),
                           getattr(st_f.photons, f)), f
    torch.testing.assert_close(st_c.light_volume, st_f.light_volume,
                               rtol=2e-5, atol=1e-7)


def test_new_time_step_resets_drain_mask(traced, seqs):
    """A stale all-true mask of an unfinished drain must not suppress the
    selection of the next time step."""
    tscene, state = traced
    _, tcfg = _configs()
    poisoned = dataclasses.replace(
        state, retraced=torch.ones_like(state.retraced),
        n_remaining=state.photons.n)
    _, st2 = ttv.advance_time(tscene, poisoned, seqs[1], 2.0, tcfg)
    assert rel_l1(st2.light_volume, state.light_volume) > 1e-3
    assert int(st2.retraced.sum()) < state.photons.n


def test_phase_rotation_advances_per_step(traced, seqs):
    """The equal-importance phase advances once per correlated step, and
    once per time step of ``play``."""
    tscene, state = traced
    _, tcfg = _configs(frac=0.05, equal_importance=True,
                       equal_importance_percentage=5)
    budget = tstep.recompute_budget(tcfg, state.photons.n)
    ones = _ones(DIM // 8, DIM)
    assert state.recompute_phase == 0
    st = tstep.correlated_step(tscene, state, tcfg, ones, budget)
    assert st.recompute_phase == 1
    st = tstep.correlated_step(tscene, st, tcfg, ones, budget)
    assert st.recompute_phase == 2
    frames = list(ttv.play(tscene, st, seqs[1], tcfg, n_frames=2))
    assert [t for t, _, _ in frames] == [0, 1]
    assert [s.recompute_phase for _, _, s in frames] == [3, 4]
    assert torch.equal(frames[1][1].volume.data, seqs[1].volumes[1])

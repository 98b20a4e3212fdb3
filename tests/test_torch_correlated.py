"""The port's correlated update against the JAX reference and against its
own semantics (CPU, 32^3 sphere, 32^2 photons, 2 interactions, as
tests/test_drain.py):

- ``trace_photons(lane_ids=...)``, ``trace_photons_chunked``,
  ``merge_recomputed``, ``splat_selected`` and ``splat_selected_delta`` on
  shared numpy arrays;
- ``correlated_step`` and ``progressive_step`` from a state of the
  reference carried over by ``io/convert.py``;
- the drain, reset, threshold and dispatch semantics of tests/test_drain.py
  and tests/test_pipeline.py, re-stated on the port.
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
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import path_importance as jpi
from cpm_tpu.ops import select as jselect
from cpm_tpu.ops import splat as jsplat
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       RenderConfig, SplatConfig,
                                       TracerConfig)
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import path_importance as tpi
from cpm_tpu_torch.ops import rng
from cpm_tpu_torch.ops import select as tselect
from cpm_tpu_torch.ops import splat as tsplat
from cpm_tpu_torch.ops import tracer as ttracer
from cpm_tpu_torch.pipeline import step as tstep
from cpm_tpu_torch.pipeline.state import ALL_DIRTY, DirtyFlags

# Lane by lane against JAX, as tests/test_torch_tracer.py: XLA and torch
# round log/exp differently and a last-ulp difference can flip a Woodcock
# decision, so 95% of lanes must agree to 1e-4.
LANE_POS_ATOL, LANE_POW_RTOL, MIN_LANE_FRACTION = 1e-4, 1e-4, 0.95
# Splats of the same deposits in two frameworks: the sums' order differs.
SPLAT_RTOL, SPLAT_ATOL_REL = 1e-4, 1e-6
# A whole step from the same state: relative L1 of the light volume.
STEP_REL_L1 = 1e-2
# The -1/+1 trick leaves fp32 cancellation residue: "nothing changed"
# and "drained equals full", as tests/test_pipeline.py:114-116, :136-138.
UNCHANGED_ATOL = 1e-4
DRAINED_RTOL = DRAINED_ATOL = 1e-3

TRACER = dict(max_interactions=2, max_steps=3000)
FIELDS = ("positions", "powers", "directions", "exit_power",
          "exit_direction")


def leaves_of(tree) -> dict:
    """A reference pytree as {field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / np.abs(want).sum())


def _t(a):
    return torch.from_numpy(np.array(a))


def _jscene(tf_points=None):
    return jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.sphere_in_box(32)),
        jtypes.TransferFunction.from_points(
            *(tf_points or synthetic.default_tf_points())),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create())


def _configs(frac=0.25, threshold=0.6, trace_chunk=None, **recompute):
    kw = dict(photons_x=32, photons_y=32)
    jcfg = JPipelineConfig(
        tracer=JTracerConfig(**TRACER), render=JRenderConfig(width=16,
                                                             height=16),
        recompute=JRecomputeConfig(max_photons_fraction=frac, **recompute),
        **kw)
    tcfg = PipelineConfig(
        tracer=TracerConfig(trace_chunk=trace_chunk, **TRACER),
        render=RenderConfig(width=16, height=16),
        recompute=RecomputeConfig(max_photons_fraction=frac, **recompute),
        splat=SplatConfig(incremental_threshold=threshold), **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def shared():
    """The reference's scene and its state after a full trace, and both
    carried over to the port."""
    scene = _jscene()
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
    return tscene, tstep.full_trace_step(
        tscene, tstep.init_state(tscene, tcfg), tcfg)


def _photons_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


# --- trace_photons(lane_ids), chunked trace ----------------------------------


def _sub_bundle(ls, ids):
    return ttypes.LightSamples(
        origins=ls.origins[ids], directions=ls.directions[ids],
        powers=ls.powers[ids], tspan=ls.tspan[ids], iteration=ls.iteration)


def test_retraced_subset_equals_the_full_traces_lanes(traced):
    """A retraced photon keeps its own random stream: the subset's lanes
    equal the same lanes of the full trace bit for bit."""
    tscene, state = traced
    _, tcfg = _configs()
    ids = _t(np.sort(np.random.default_rng(0).choice(1024, 200,
                                                     replace=False)))
    key = rng.fold_in(state.key, 0)
    sub = ttracer.trace_photons(
        tscene.volume, tscene.tf, tscene.tf_scattering,
        _sub_bundle(state.light_samples, ids), key, tcfg.tracer,
        lane_ids=ids)
    full = state.photons
    assert int((sub.positions[..., 0] < 1e30).sum()) > 50
    for f in ("positions", "powers", "directions"):
        assert torch.equal(getattr(sub, f), getattr(full, f)[:, ids]), f
    assert torch.equal(sub.exit_power, full.exit_power[ids])
    assert torch.equal(sub.exit_direction, full.exit_direction[ids])
    # Without the ids the lanes draw other streams.
    other = ttracer.trace_photons(
        tscene.volume, tscene.tf, tscene.tf_scattering,
        _sub_bundle(state.light_samples, ids), key, tcfg.tracer)
    assert not torch.equal(other.positions, sub.positions)
    with pytest.raises(ValueError):
        ttracer.trace_photons(
            tscene.volume, tscene.tf, tscene.tf_scattering,
            _sub_bundle(state.light_samples, ids), key, tcfg.tracer,
            lane_ids=ids[:-1])


def test_retraced_subset_matches_reference_lane_by_lane(shared):
    scene, state, tscene, tstate = shared
    jcfg, tcfg = _configs()
    ids = np.sort(np.random.default_rng(1).choice(1024, 256, replace=False))
    jls = state.light_samples
    jsub = jtypes.LightSamples(
        origins=jls.origins[ids], directions=jls.directions[ids],
        powers=jls.powers[ids], tspan=jls.tspan[ids],
        iteration=jls.iteration)
    jph = jtracer.trace_photons(
        scene.volume, scene.tf, scene.tf_scattering, jsub,
        jax.random.PRNGKey(9), jcfg.tracer,
        lane_ids=jnp.asarray(ids, jnp.int32))
    tph = ttracer.trace_photons(
        tscene.volume, tscene.tf, tscene.tf_scattering,
        _sub_bundle(tstate.light_samples, _t(ids)), rng.prng_key(9),
        tcfg.tracer, lane_ids=_t(ids))
    jp, tp = np.asarray(jph.positions), tph.positions.numpy()
    jw, tw = np.asarray(jph.powers), tph.powers.numpy()
    used = jp[..., 0] < 1e30
    ok = (np.all(used == (tp[..., 0] < 1e30), axis=0)
          & np.all(np.where(used[..., None], np.abs(jp - tp), 0.0)
                   <= LANE_POS_ATOL, axis=(0, 2))
          & np.all(np.isclose(tw, jw, rtol=LANE_POW_RTOL, atol=0.0),
                   axis=(0, 2)))
    print(f"{ok.mean():.4f} of {ok.size} retraced lanes agree")
    assert used.sum() > 50
    assert ok.mean() >= MIN_LANE_FRACTION


@pytest.mark.parametrize("chunk", [256, 300, 1000, 1024, 5000])
def test_chunked_trace_is_bit_identical(traced, chunk):
    """Chunks that divide n, that leave a last partial chunk, and one that
    holds every lane."""
    tscene, state = traced
    _, tcfg = _configs()
    got = ttracer.trace_photons_chunked(
        tscene.volume, tscene.tf, tscene.tf_scattering, state.light_samples,
        rng.fold_in(state.key, 0), tcfg.tracer, chunk)
    assert got.n == 1024
    assert _photons_equal(got, state.photons)


def test_chunked_trace_carries_lane_ids(traced):
    tscene, state = traced
    _, tcfg = _configs()
    ids = _t(np.random.default_rng(2).permutation(1024)[:500])
    args = (tscene.volume, tscene.tf, tscene.tf_scattering,
            _sub_bundle(state.light_samples, ids), rng.fold_in(state.key, 0),
            tcfg.tracer)
    whole = ttracer.trace_photons(*args, lane_ids=ids)
    assert _photons_equal(
        ttracer.trace_photons_chunked(*args, 128, lane_ids=ids), whole)
    with pytest.raises(ValueError):
        ttracer.trace_photons_chunked(*args, 0)


def test_full_trace_step_honours_trace_chunk(traced):
    tscene, state = traced
    _, tcfg = _configs(trace_chunk=300)
    chunked = tstep.full_trace_step(
        tscene, tstep.init_state(tscene, tcfg), tcfg)
    assert _photons_equal(chunked.photons, state.photons)
    assert torch.equal(chunked.light_volume, state.light_volume)


# --- merge and the selected splats on shared arrays ---------------------------


def _random_photons(seed, max_i, n):
    rs = np.random.default_rng(seed)
    pos = rs.random((max_i, n, 3), dtype=np.float32)
    pw = rs.random((max_i, n, 3), dtype=np.float32)
    unused = rs.random((max_i, n)) < 0.4
    pos[unused] = np.float32(3.4028235e38)
    pw[unused] = 0.0
    arrays = dict(
        positions=pos, powers=pw,
        directions=rs.random((max_i, n, 2), dtype=np.float32),
        exit_power=rs.random(n, dtype=np.float32),
        exit_direction=rs.random((n, 2), dtype=np.float32))
    radius, scene_radius = np.float32(0.11), np.float32(1.7320508)
    j = jtypes.PhotonData(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          radius_rel=jnp.float32(radius),
                          scene_radius=jnp.float32(scene_radius),
                          iteration=jnp.int32(0))
    t = ttypes.PhotonData(**{k: _t(v) for k, v in arrays.items()},
                          radius_rel=float(radius),
                          scene_radius=float(scene_radius))
    return j, t


def _selection(seed, n, b, n_valid):
    """b lanes: n_valid distinct photon ids, then padding lanes whose index
    is a photon that a valid lane also names."""
    rs = np.random.default_rng(seed)
    idx = rs.permutation(n)[:b].astype(np.int64)
    valid = np.arange(b) < n_valid
    idx[~valid] = idx[0]
    perm = rs.permutation(b)
    return idx[perm], valid[perm]


@pytest.mark.parametrize("n_valid", [0, 9, 16])
def test_merge_recomputed_matches_and_padding_writes_nothing(n_valid):
    jold, told = _random_photons(0, 3, 64)
    jnew, tnew = _random_photons(1, 3, 16)
    idx, valid = _selection(2, 64, 16, n_valid)
    want = jtracer.merge_recomputed(jold, jnew, jnp.asarray(idx, jnp.int32),
                                    jnp.asarray(valid))
    before = {f: getattr(told, f).clone() for f in FIELDS}
    got = ttracer.merge_recomputed(told, tnew, _t(idx), _t(valid))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
        assert torch.equal(getattr(told, f), before[f]), f  # input untouched
    touched = np.zeros(64, bool)
    touched[idx[valid]] = True
    assert torch.equal(got.positions[:, ~touched],
                       told.positions[:, ~touched])
    assert torch.equal(got.exit_power[~touched], told.exit_power[~touched])
    if n_valid:
        assert torch.equal(got.positions[:, idx[valid]],
                           tnew.positions[:, valid])
    assert got.radius_rel == told.radius_rel and got.n == 64


@pytest.mark.parametrize("method", ["scatter", "matmul"])
@pytest.mark.parametrize("what", ["delta", "remove", "add"])
def test_selected_splats_match(what, method):
    jold, told = _random_photons(3, 2, 96)
    jnew, tnew = _random_photons(4, 2, 96)
    idx, valid = _selection(5, 96, 32, 20)
    dim, fp = (8, 8, 8), 4
    jargs = (jnp.asarray(idx, jnp.int32), jnp.asarray(valid), dim, fp)
    targs = (_t(idx), _t(valid), dim, fp)
    if what == "delta":
        want = jsplat.splat_selected_delta(jold, jnew, *jargs, method=method)
        got = tsplat.splat_selected_delta(told, tnew, *targs, method=method)
    else:
        mult = -1.0 if what == "remove" else 1.0
        want = jsplat.splat_selected(jold, *jargs, multiplier=mult,
                                     method=method)
        got = tsplat.splat_selected(told, *targs, multiplier=mult,
                                    method=method)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(
        got.numpy(), want, rtol=SPLAT_RTOL,
        atol=SPLAT_ATOL_REL * float(np.abs(want).max()))


def test_delta_is_removed_plus_added_and_skips_padding():
    _, told = _random_photons(3, 2, 96)
    _, tnew = _random_photons(4, 2, 96)
    idx, valid = _selection(5, 96, 32, 20)
    dim = (8, 8, 8)
    delta = tsplat.splat_selected_delta(told, tnew, _t(idx), _t(valid), dim,
                                        method="matmul")
    two = (tsplat.splat_selected(tnew, _t(idx), _t(valid), dim,
                                 method="matmul")
           - tsplat.splat_selected(told, _t(idx), _t(valid), dim,
                                   method="matmul"))
    scale = float(two.abs().max())
    torch.testing.assert_close(delta, two, rtol=SPLAT_RTOL,
                               atol=1e-5 * scale)
    # Only the valid lanes count: the same photons with no padding lanes.
    tight = tsplat.splat_selected_delta(
        told, tnew, _t(idx[valid]), _t(valid[valid]), dim, method="matmul")
    torch.testing.assert_close(delta, tight, rtol=SPLAT_RTOL,
                               atol=1e-5 * scale)
    pos, pw = tsplat.delta_deposits(told, tnew, _t(idx), _t(valid))
    assert tuple(pos.shape) == tuple(pw.shape) == (2 * 2 * 32, 3)
    assert pos.is_contiguous() and pw.is_contiguous()
    assert float(pw[:64].max()) <= 0.0 <= float(pw[64:].min())
    with pytest.raises(ValueError):
        tsplat.splat_selected_delta(told, tnew, _t(idx), _t(valid), dim,
                                    method="pallas")


# --- whole steps from a shared state -----------------------------------------


def _edited_tf():
    pos, col = synthetic.default_tf_points()
    col = np.array(col, np.float32)
    col[:, 3] = np.clip(col[:, 3] * 1.6, 0.0, 1.0)
    return np.asarray(pos, np.float32), col


@pytest.mark.parametrize("case", ["equal_importance", "equal_half",
                                  "corner_grid"])
def test_correlated_step_matches_reference(shared, case):
    """From the reference's state after a TF edit: the same photons are
    selected, the bookkeeping is equal and the light volume within 1%.
    The ranks are unambiguous in every case: equal importance is exactly 0
    or 1 (a fifth of the photons, fewer than a batch; or half of them, two
    batches, where ties go to the lowest index), and the corner grid flags
    fewer photons than the budget holds, so the selected set does not
    depend on the last bits of the importance."""
    _, state, _, tstate = shared
    scene = _jscene(_edited_tf())
    tscene = convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                      device="cpu")
    percentage = {"equal_importance": 20, "equal_half": 50}.get(case)
    if percentage:
        jcfg, tcfg = _configs(frac=0.25, equal_importance=True,
                              equal_importance_percentage=percentage)
    else:
        jcfg, tcfg = _configs(frac=0.5)
    jgrid = jstep.build_importance_grid(scene, jcfg)
    data = np.zeros((4, 4, 4), np.float32)
    data[0, 3, 0] = 1.0
    jgrid = jgrid.replace(data=jnp.asarray(data))
    tgrid = ttypes.UniformGrid3D(data=_t(data),
                                 cell_dim=_t(jgrid.cell_dim),
                                 volume_dim=_t(jgrid.volume_dim))
    budget = jstep.recompute_budget(jcfg, 1024)
    assert tstep.recompute_budget(tcfg, 1024) == budget

    state = state.replace(recompute_phase=jnp.int32(3))
    tstate = dataclasses.replace(tstate, recompute_phase=3)

    # The selection itself, through the same functions the step calls.
    if percentage:
        jimp = jpi.equal_importance(1024, state.recompute_phase, percentage)
        timp = tpi.equal_importance(1024, 3, percentage, device="cpu")
    else:
        jimp = jstep.recompute_importance(jcfg, jgrid, state.photons,
                                          state.light_samples)
        timp = tstep.recompute_importance(tcfg, tgrid, tstate.photons,
                                          tstate.light_samples)
    jidx, jvalid, _ = jselect.select_photons_to_recompute(jimp, budget)
    tidx, tvalid, _ = tselect.select_photons_to_recompute(timp, budget)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tidx.numpy()[tvalid.numpy()],
                                  np.asarray(jidx)[np.asarray(jvalid)])
    selected = np.zeros(1024, bool)
    selected[tidx.numpy()[tvalid.numpy()]] = True
    assert 20 < selected.sum() <= budget

    want = jstep.correlated_step(scene, state, jcfg, jgrid, budget)
    got = tstep.correlated_step(tscene, tstate, tcfg, tgrid, budget)

    # Only selected photons change, in both packages.
    jchanged = np.any(np.asarray(want.photons.positions)
                      != np.asarray(state.photons.positions), axis=(0, 2))
    tchanged = torch.any(got.photons.positions != tstate.photons.positions,
                         dim=2).any(dim=0).numpy()
    assert jchanged.sum() > 20 and tchanged.sum() > 20
    assert not jchanged[~selected].any() and not tchanged[~selected].any()
    # Lanes that changed in one package and not in the other are lanes
    # whose retrace landed on the old path in one of them: few.
    assert (jchanged != tchanged).mean() < 0.02
    np.testing.assert_array_equal(np.asarray(want.retraced),
                                  got.retraced.numpy())
    assert got.n_remaining == int(want.n_remaining)
    assert got.recompute_phase == int(want.recompute_phase) == 4
    assert got.photons.iteration == int(want.photons.iteration) == 0
    if case == "equal_half":
        # Two batches: the first holds the 256 lowest flagged ids.
        assert got.n_remaining == 256
        np.testing.assert_array_equal(got.retraced.numpy(), selected)
    else:
        assert got.n_remaining == 0 and not bool(got.retraced.any())
    lv, want_lv = got.light_volume.numpy(), np.asarray(want.light_volume)
    moved = rel_l1(want_lv, np.asarray(state.light_volume))
    print(f"{case}: {int(selected.sum())} photons selected, "
          f"{int(jchanged.sum())} changed, the step moved the light volume "
          f"by rel L1 {moved:.3e}; port vs reference "
          f"{rel_l1(lv, want_lv):.3e}")
    assert moved > 10 * STEP_REL_L1  # the edit shows in the volume
    assert rel_l1(lv, want_lv) < STEP_REL_L1
    assert torch.equal(got.light_volume_accum, got.light_volume)


def test_progressive_step_matches_reference(shared):
    scene, state, tscene, tstate = shared
    jcfg, tcfg = _configs()
    want = jstep.progressive_step(scene, state, jcfg)
    got = tstep.progressive_step(tscene, tstate, tcfg)
    assert got.photons.iteration == int(want.photons.iteration) == 1
    assert got.photons.radius_rel == pytest.approx(
        float(want.photons.radius_rel), rel=1e-6)
    assert got.photons.radius_rel < tstate.photons.radius_rel
    assert rel_l1(got.light_volume.numpy(),
                  np.asarray(want.light_volume)) < STEP_REL_L1
    assert rel_l1(got.light_volume_accum.numpy(),
                  np.asarray(want.light_volume_accum)) < STEP_REL_L1
    # A fresh wave: other streams than iteration 0's.
    assert not torch.equal(got.photons.positions, tstate.photons.positions)
    again = tstep.progressive_step(tscene, got, tcfg)
    assert again.photons.iteration == 2
    want_accum = (got.light_volume_accum * 2.0 + again.light_volume) / 3.0
    torch.testing.assert_close(again.light_volume_accum, want_accum,
                               rtol=1e-6, atol=0.0)


# --- the drain, reset, threshold and dispatch semantics on the port ------------


def _stale(tscene, st, cfg):
    """A state whose photons are another wave's and whose light volume is
    their splat at the configuration's radius, which is what the -1/+1
    update assumes of the volume it corrects."""
    wave = tstep.progressive_step(tscene, st, cfg)
    photons = dataclasses.replace(
        wave.photons, iteration=0,
        radius_rel=float(np.float32(cfg.tracer.radius_rel)))
    lv = tsplat.splat_all(photons, tstep.light_volume_shape(cfg),
                          tstep.splat_footprint(cfg), method="matmul")
    return dataclasses.replace(wave, photons=photons, light_volume=lv,
                               light_volume_accum=lv)


def _ones(grid):
    return dataclasses.replace(grid, data=torch.ones_like(grid.data))


def test_drain_converges_and_never_repeats(traced):
    tscene, st = traced
    _, cfg = _configs(frac=0.1)
    ig = tstep.build_importance_grid(tscene, cfg)
    imp0 = tstep.recompute_importance(cfg, ig, st.photons, st.light_samples)
    n_flagged = int((imp0 > 0).sum())
    budget = tstep.recompute_budget(cfg, st.photons.n)
    assert 0 < budget < n_flagged  # a multi-batch drain

    st = tstep.step(tscene, st, cfg, DirtyFlags(tf=True), ig)
    seen = st.retraced.clone()
    assert int(seen.sum()) == min(budget, n_flagged)
    assert st.n_remaining == n_flagged - budget
    batches = 1
    while st.n_remaining > 0:
        prev = seen.clone()
        st = tstep.step(tscene, st, cfg, DirtyFlags(progressive=True), ig)
        if st.n_remaining > 0:
            # The mask grows monotonically; no photon is retraced twice.
            assert bool(st.retraced[prev].all())
            assert int(st.retraced.sum()) == int(prev.sum()) + budget
            seen = st.retraced.clone()
        batches += 1
        assert batches < 64, "drain did not converge"
    assert batches == -(-n_flagged // budget)
    assert st.n_remaining == 0 and not bool(st.retraced.any())
    assert st.recompute_phase == batches
    assert isinstance(st.n_remaining, int)


def test_fresh_invalidation_resets_round(traced):
    tscene, st = traced
    _, cfg = _configs(frac=0.1)
    ig = tstep.build_importance_grid(tscene, cfg)
    st = tstep.step(tscene, st, cfg, DirtyFlags(tf=True), ig)
    assert st.n_remaining > 0 and int(st.retraced.sum()) > 0
    # A second edit mid-drain restarts from the top priorities.
    st2 = tstep.step(tscene, st, cfg, DirtyFlags(volume=True), ig)
    assert torch.equal(st2.retraced, st.retraced)
    assert st2.n_remaining == st.n_remaining


def test_correlated_resets_progressive_state(traced):
    tscene, st = traced
    _, cfg = _configs(frac=0.5)
    st = tstep.step(tscene, st, cfg, DirtyFlags(progressive=True))
    st = tstep.step(tscene, st, cfg, DirtyFlags(progressive=True))
    assert st.photons.iteration == 2
    assert st.photons.radius_rel < np.float32(cfg.tracer.radius_rel)
    assert not torch.equal(st.light_volume_accum, st.light_volume)
    ig = tstep.build_importance_grid(tscene, cfg)
    st2 = tstep.step(tscene, st, cfg, DirtyFlags(tf=True), ig)
    assert st2.photons.iteration == 0
    assert st2.photons.radius_rel == float(np.float32(cfg.tracer.radius_rel))
    assert torch.equal(st2.light_volume_accum, st2.light_volume)


def test_large_batch_triggers_full_resplat(traced):
    """Past ``incremental_threshold`` the volume is rebuilt from scratch:
    it matches a full trace and ignores a poisoned prior volume."""
    tscene, st = traced
    _, cfg = _configs(frac=1.0, threshold=0.5)
    ones = _ones(tstep.build_importance_grid(tscene, cfg))
    poison = dataclasses.replace(st, light_volume=st.light_volume + 123.0)
    budget = tstep.recompute_budget(cfg, st.photons.n)
    st2 = tstep.correlated_step(tscene, poison, cfg, ones, budget)
    full = tstep.full_trace_step(tscene, st, cfg)
    torch.testing.assert_close(st2.light_volume, full.light_volume,
                               rtol=DRAINED_RTOL, atol=DRAINED_ATOL)
    assert st2.n_remaining == 0
    # Under the threshold the same batch is incremental and keeps the term.
    _, cfg_inc = _configs(frac=1.0, threshold=2.0)
    st3 = tstep.correlated_step(tscene, poison, cfg_inc, ones, budget)
    assert float((st3.light_volume - full.light_volume).mean()) \
        == pytest.approx(123.0, rel=1e-3)
    # A budget that can reach the threshold with a batch that does not.
    _, cfg_few = _configs(frac=1.0, threshold=0.5,
                          equal_importance=True,
                          equal_importance_percentage=10)
    st4 = tstep.correlated_step(tscene, poison, cfg_few, ones, budget)
    assert float((st4.light_volume - full.light_volume).mean()) \
        == pytest.approx(123.0, rel=1e-3)


def test_zero_importance_changes_nothing(traced):
    tscene, st = traced
    _, cfg = _configs()
    ig = tstep.build_importance_grid(tscene, cfg)
    zero = dataclasses.replace(ig, data=torch.zeros_like(ig.data))
    st2 = tstep.correlated_step(tscene, st, cfg, zero,
                                tstep.recompute_budget(cfg, st.photons.n))
    torch.testing.assert_close(st2.light_volume, st.light_volume, rtol=0.0,
                               atol=UNCHANGED_ATOL)
    assert st2.n_remaining == 0
    assert _photons_equal(st2.photons, st.photons)


@pytest.mark.parametrize("scalable", [False, True])
def test_drained_uniform_grid_equals_full_trace(traced, scalable):
    """Two 50% batches over a grid of ones retrace every photon with the
    iteration-0 key: the light volume of a full trace."""
    tscene, st = traced
    _, cfg = _configs(frac=0.5)
    ones = _ones(tstep.build_importance_grid(tscene, cfg))
    budget = tstep.recompute_budget(cfg, st.photons.n)
    step_fn = (tstep.correlated_step_scalable if scalable
               else tstep.correlated_step)
    stale = _stale(tscene, st, cfg)
    st1 = step_fn(tscene, stale, cfg, ones, budget)
    assert st1.n_remaining == st.photons.n - budget  # the budget is kept
    assert int(st1.retraced.sum()) == budget
    st2 = step_fn(tscene, st1, cfg, ones, budget)
    assert st2.n_remaining == 0
    full = tstep.full_trace_step(tscene, st, cfg)
    assert _photons_equal(st2.photons, full.photons)
    torch.testing.assert_close(st2.light_volume, full.light_volume,
                               rtol=DRAINED_RTOL, atol=DRAINED_ATOL)


@pytest.mark.parametrize("trace_chunk", [None, 100])
def test_scalable_step_equals_correlated_step(traced, trace_chunk):
    """Same selection, same photons, same bookkeeping; the light volume
    within the splats' rounding. A ``trace_chunk`` that does not divide the
    budget (256) traces a last partial chunk."""
    tscene, st = traced
    _, cfg = _configs(frac=0.25)
    _, cfg_chunk = _configs(frac=0.25, trace_chunk=trace_chunk)
    ig = tstep.build_importance_grid(tscene, cfg)
    budget = tstep.recompute_budget(cfg, st.photons.n)
    wave = tstep.progressive_step(tscene, st, cfg)
    a = tstep.correlated_step(tscene, wave, cfg, ig, budget)
    b = tstep.correlated_step_scalable(tscene, wave, cfg_chunk, ig, budget)
    assert _photons_equal(a.photons, b.photons)
    assert not _photons_equal(a.photons, wave.photons)
    assert torch.equal(a.retraced, b.retraced)
    assert (a.n_remaining, a.recompute_phase) == (b.n_remaining,
                                                  b.recompute_phase)
    scale = float(a.light_volume.abs().max())
    torch.testing.assert_close(b.light_volume, a.light_volume,
                               rtol=SPLAT_RTOL, atol=1e-5 * scale)
    assert torch.equal(b.light_volume_accum, b.light_volume)


def test_equal_importance_rotates_with_the_phase(traced):
    tscene, st = traced
    _, cfg = _configs(frac=0.25, equal_importance=True,
                      equal_importance_percentage=10)
    budget = tstep.recompute_budget(cfg, st.photons.n)
    wave = tstep.progressive_step(tscene, st, cfg)
    changed = []
    for phase in (0, 1):
        s = dataclasses.replace(wave, recompute_phase=phase)
        out = tstep.correlated_step(tscene, s, cfg, None, budget)
        assert out.recompute_phase == phase + 1
        changed.append(torch.any(out.photons.exit_direction
                                 != wave.photons.exit_direction, dim=1))
    ids = torch.arange(1024)
    assert not bool(changed[0][ids % 10 != 0].any())
    assert not bool(changed[1][(ids + 1) % 10 != 0].any())
    assert int(changed[0].sum()) > 10 and int(changed[1].sum()) > 10


@pytest.mark.parametrize("flags,grid,path", [
    (ALL_DIRTY, True, "full"),
    (DirtyFlags(light=True), True, "full"),
    (DirtyFlags(camera=True, tf=True), True, "full"),
    (DirtyFlags(tf=True), False, "full"),
    (DirtyFlags(volume=True), False, "full"),
    (DirtyFlags(tf=True), True, "correlated"),
    (DirtyFlags(volume=True, progressive=True), True, "correlated"),
    (DirtyFlags(progressive=True), True, "progressive"),
    (DirtyFlags(progressive=True), False, "progressive"),
    (DirtyFlags(), True, "none"),
])
def test_step_dispatch(traced, monkeypatch, flags, grid, path):
    tscene, st = traced
    _, cfg = _configs(frac=0.1)
    ig = _ones(tstep.build_importance_grid(tscene, cfg)) if grid else None
    calls = []
    for name in ("full_trace_step", "correlated_step", "progressive_step"):
        fn = getattr(tstep, name)
        monkeypatch.setattr(
            tstep, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    stale = dataclasses.replace(st, retraced=torch.ones_like(st.retraced),
                                n_remaining=0)
    out = tstep.step(tscene, stale, cfg, flags, ig)
    want = {"full": ["full_trace_step"], "correlated": ["correlated_step"],
            "progressive": ["progressive_step"], "none": []}[path]
    assert calls == want
    if path == "none":
        assert out is stale
    elif path == "correlated":
        # A fresh invalidation clears the stale mask before it selects.
        assert out.n_remaining == st.photons.n - tstep.recompute_budget(
            cfg, st.photons.n)
    elif path == "full":
        assert not bool(out.retraced.any()) and out.photons.iteration == 0
    else:
        assert out.photons.iteration == 1


def test_progressive_drains_remaining_first(traced):
    tscene, st = traced
    _, cfg = _configs(frac=0.1)
    ones = _ones(tstep.build_importance_grid(tscene, cfg))
    st = tstep.step(tscene, st, cfg, DirtyFlags(tf=True), ones)
    assert st.n_remaining > 0
    st2 = tstep.step(tscene, st, cfg, DirtyFlags(progressive=True), ones)
    assert st2.n_remaining < st.n_remaining
    assert st2.photons.iteration == st.photons.iteration == 0
    # With no grid connected the tick refines instead.
    st3 = tstep.step(tscene, st, cfg, DirtyFlags(progressive=True))
    assert st3.photons.iteration == 1 and st3.n_remaining == st.n_remaining

"""The tracer's forward options in the port against the JAX reference
(CPU, 16^3 cloud, 32^2 lanes): ``no_single_scattering`` lane by lane,
``photon_dtype="float16"`` (a float32 trace cast at the end) and
``return_stats`` (the wavefront counters); then the float16 photons
downstream: splat, path importance, a correlated step, and the frame
with no single scattering."""

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
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import phase as jphase
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       RenderConfig, TracerConfig)
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import rng, splat, tracer
from cpm_tpu_torch.pipeline import step as tstep

torch.set_num_threads(1)

# Lane by lane, as tests/test_torch_tracer.py: XLA and torch round log/exp
# differently, and a flipped Woodcock decision sends a lane elsewhere; so
# 95% of lanes must agree to 1e-4 in position and power.
LANE_POS_ATOL, LANE_POW_RTOL, MIN_LANE_FRACTION = 1e-4, 1e-4, 0.95
# float16 storage against float32 (tests/test_misc_parity.py:32-48):
# positions within the ~2^-11 quantization, a splat within 2% rel L1.
F16_POS_ATOL, F16_SPLAT_REL_L1 = 1e-3, 0.02
# At the default radius the rounding of a position (up to 2^-12 in
# [0.5, 1)) moves an Epanechnikov weight by up to 1.5 * 2^-12 / r = 2.4%
# of its peak per axis; the relative L1 of the splat is near that.
F16_DEFAULT_REL_L1 = 0.05
# Whole frames and steps from the same state: relative L1.
FRAME_REL_L1 = 1e-2
FIELDS = ("positions", "powers", "directions", "exit_power",
          "exit_direction")


def leaves_of(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / np.abs(want).sum())


@pytest.fixture(scope="module")
def scene():
    data = synthetic.smoke_cloud(16, seed=6)
    tf, tfs = (synthetic.default_tf_points(),
               synthetic.default_scattering_points())
    jargs = (jtypes.Volume.from_data(data),
             jtypes.TransferFunction.from_points(*tf),
             jtypes.TransferFunction.from_points(*tfs))
    targs = (ttypes.Volume.from_data(data, device="cpu"),
             ttypes.TransferFunction.from_points(*tf, device="cpu"),
             ttypes.TransferFunction.from_points(*tfs, device="cpu"))
    jls = jemit.emit(jlights.Light.directional((0.0, -1.0, 0.3)),
                     jsampling.stratified_grid_2d(32, 32))
    tls = ttypes.LightSamples(
        **{f: torch.from_numpy(np.array(getattr(jls, f)))
           for f in ("origins", "directions", "powers", "tspan")})
    return jargs, jls, targs, tls


def _trace(scene, kw, stats=False, jkw=None):
    """(reference output, port output) of the same trace."""
    (jvol, jtf, jtfs), jls, (tvol, ttf, ttfs), tls = scene
    jout = jtracer.trace_photons(jvol, jtf, jtfs, jls,
                                 jax.random.PRNGKey(11),
                                 JTracerConfig(**kw, **(jkw or {})),
                                 return_stats=stats)
    tout = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(11),
                                TracerConfig(**kw), return_stats=stats)
    return jout, tout


def _lane_agreement(jph, tph):
    """Per lane: same used slots, positions within LANE_POS_ATOL and
    powers within LANE_POW_RTOL (both read in float32)."""
    jp = np.asarray(jph.positions).astype(np.float32)
    tp = tph.positions.float().numpy()
    jw = np.asarray(jph.powers).astype(np.float32)
    tw = tph.powers.float().numpy()
    used = jp[..., 0] < 1e30
    same_slots = np.all(used == (tp[..., 0] < 1e30), axis=0)
    pos_ok = np.all(np.where(used[..., None], np.abs(jp - tp), 0.0)
                    <= LANE_POS_ATOL, axis=(0, 2))
    pow_ok = np.all(np.isclose(tw, jw, rtol=LANE_POW_RTOL, atol=0.0),
                    axis=(0, 2))
    return same_slots & pos_ok & pow_ok, used


# --- no_single_scattering ---------------------------------------------------

NSS_CASES = {
    "isotropic": dict(max_interactions=2, max_steps=1200,
                      no_single_scattering=True),
    "hg_three": dict(max_interactions=3, max_steps=1200,
                     no_single_scattering=True,
                     phase_type=jphase.HENYEY_GREENSTEIN, phase_g=0.6),
}


@pytest.mark.parametrize("case", sorted(NSS_CASES))
def test_no_single_scattering_matches_reference_lane_by_lane(scene, case):
    jph, tph = _trace(scene, NSS_CASES[case])
    ok, used = _lane_agreement(jph, tph)
    frac = float(ok.mean())
    print(f"{case}: {frac:.4f} of {ok.size} lanes agree; "
          f"{int(used.sum())} reference deposits")
    assert used.sum() > 100
    assert frac >= MIN_LANE_FRACTION
    np.testing.assert_allclose(tph.exit_power.numpy()[ok],
                               np.asarray(jph.exit_power)[ok], rtol=1e-4)
    np.testing.assert_allclose(tph.exit_direction.numpy()[ok],
                               np.asarray(jph.exit_direction)[ok],
                               rtol=1e-4, atol=1e-4)


def test_no_single_scattering_skips_the_first_collision(scene):
    """Without single scattering, a lane stores at most I deposits from
    its second collision on: the first deposit of the plain trace is not
    stored, and the deposits' powers carry the 1/pdf of the first
    scatter (isotropic: 4 pi)."""
    kw = dict(max_interactions=2, max_steps=1200)
    (_, _, (tvol, ttf, ttfs), tls) = scene
    plain = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(11),
                                 TracerConfig(**kw))
    nss = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(11),
                               TracerConfig(no_single_scattering=True, **kw))
    p_used = plain.positions[0, :, 0] < 1e30
    n_used = nss.positions[0, :, 0] < 1e30
    # A lane with no collision deposits in neither; a deposit without
    # single scattering needs a first collision, which the plain trace
    # deposits.
    assert bool((~n_used | p_used).all())
    assert 0 < int(n_used.sum()) < int(p_used.sum())
    # The plain trace's first deposit sits where the lane first collided,
    # and that is where the no-single-scattering lane changed direction:
    # its first stored direction is no longer the light's.
    light_dir = ttypes.encode_direction(tls.directions)
    moved = (nss.directions[0] - light_dir).abs().amax(dim=-1) > 1e-4
    assert bool(moved[n_used].all())
    ratio = (nss.powers[0, n_used].sum() / plain.powers[0, n_used].sum())
    assert float(ratio) > 1.0


# --- photon_dtype="float16" ------------------------------------------------


def test_float16_is_the_float32_trace_cast(scene):
    """The trace runs in float32 and only the three deposit fields are
    cast: equal to the float32 trace's cast bit for bit, FLT_MAX -> +inf,
    and the exit fields stay float32."""
    (_, _, (tvol, ttf, ttfs), tls) = scene
    kw = dict(max_interactions=2, max_steps=1200)
    p32 = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(11),
                               TracerConfig(**kw))
    p16 = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(11),
                               TracerConfig(photon_dtype="float16", **kw))
    for f in ("positions", "powers", "directions"):
        assert getattr(p16, f).dtype == torch.float16, f
        assert torch.equal(getattr(p16, f), getattr(p32, f).half()), f
    for f in ("exit_power", "exit_direction"):
        assert getattr(p16, f).dtype == torch.float32
        assert torch.equal(getattr(p16, f), getattr(p32, f)), f
    unused = p32.positions[..., 0] > 1e30
    assert bool(unused.any())
    assert bool(torch.isinf(p16.positions[..., 0][unused]).all())


def test_float16_matches_reference(scene):
    """Against the reference's float16 trace: the same deposit set on the
    lanes that agree (at least 95%), and positions that are the float16
    cast of values equal to 1e-4 (so within one float16 ulp)."""
    kw = dict(max_interactions=2, max_steps=1200, photon_dtype="float16")
    jph, tph = _trace(scene, kw)
    assert np.asarray(jph.positions).dtype == np.float16
    assert tph.positions.dtype == torch.float16
    ok, used = _lane_agreement(jph, tph)
    assert used.sum() > 100 and ok.mean() >= MIN_LANE_FRACTION
    jp = np.asarray(jph.positions).astype(np.float32)[:, ok]
    tp = tph.positions.float().numpy()[:, ok]
    np.testing.assert_array_equal(jp[..., 0] < 1e30, tp[..., 0] < 1e30)
    dep = jp[..., 0] < 1e30
    np.testing.assert_allclose(tp[dep], jp[dep], atol=F16_POS_ATOL)


@pytest.mark.parametrize("radius,dim,bound", [
    (0.06, 17, F16_SPLAT_REL_L1), (0.0153866, 65, F16_DEFAULT_REL_L1)])
def test_float16_splat_close_to_float32(scene, radius, dim, bound):
    """The splat of the float16 photons against the float32 photons', by
    the radial scatter and the product kernel's plain version, on the
    light volume the radius gives (ceil(1 / r) a side). The reference's
    own test (tests/test_misc_parity.py:32-48) splats into 8^3 at the
    default radius, where no voxel centre lies within r of a deposit: both
    volumes are 0 there."""
    (_, _, (tvol, ttf, ttfs), tls) = scene
    kw = dict(max_interactions=2, max_steps=800, radius_rel=radius)
    p32 = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(1),
                               TracerConfig(**kw))
    p16 = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(1),
                               TracerConfig(photon_dtype="float16", **kw))
    wide = dataclasses.replace(p16, positions=p16.positions.float(),
                               powers=p16.powers.float())
    for method in ("scatter", "matmul"):
        lv32 = splat.splat_all(p32, (dim,) * 3, footprint=4, method=method)
        lv16 = splat.splat_all(p16, (dim,) * 3, footprint=4, method=method)
        assert lv16.dtype == torch.float32
        assert float(lv32.sum()) > 0.0
        err = rel_l1(lv16.numpy(), lv32.numpy())
        print(f"r {radius}, {dim}^3, {method}: rel L1 {err:.4f}")
        assert err < bound, method
        # It is the float32 splat of the widened values.
        np.testing.assert_array_equal(
            lv16.numpy(), splat.splat_all(wide, (dim,) * 3, footprint=4,
                                          method=method).numpy())


# --- return_stats ------------------------------------------------------------


@pytest.mark.parametrize("compaction", [True, False])
def test_return_stats_matches_reference(scene, compaction):
    """wavefront_iters exact; the active history and the mean active
    fraction within what the diverging lanes can move: each lane that does
    not agree changes a flight's active count by at most one."""
    kw = dict(max_interactions=2, max_steps=1200)
    (jph, jst), (tph, tst) = _trace(
        scene, kw, stats=True, jkw=dict(use_compaction=compaction))
    ok, _ = _lane_agreement(jph, tph)
    n = ok.size
    n_div = int((~ok).sum())
    iters = int(jst["wavefront_iters"])
    assert tst["wavefront_iters"] == iters
    assert tst["stage_widths"] == [n]
    hist, jhist = tst["active_history"].numpy(), np.asarray(
        jst["active_history"])
    assert hist.dtype == np.int32 and hist.shape == (512,)
    assert np.abs(hist.astype(np.int64) - jhist).max() <= n_div
    assert hist[0] == jhist[0] > 0
    frac = float(tst["mean_active_frac"])
    assert abs(frac - float(jst["mean_active_frac"])) <= n_div / n + 1e-6
    assert 0.0 < frac <= 1.0
    print(f"compaction {compaction}: {iters} flights, mean active "
          f"{frac:.4f}, {n_div} diverging lanes")


def test_return_stats_changes_nothing_and_counts_every_flight(scene):
    (_, _, (tvol, ttf, ttfs), tls) = scene
    cfg = TracerConfig(max_interactions=2, max_steps=1200,
                       flights_per_iteration=3)
    plain = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(4), cfg)
    ph, st = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(4),
                                  cfg, return_stats=True)
    for f in FIELDS:
        assert torch.equal(getattr(ph, f), getattr(plain, f)), f
    iters = st["wavefront_iters"]
    hist = st["active_history"]
    # Whole K-groups of flights; the loop ends after a group in which the
    # last lane ended, so the group's later flights may count 0 lanes.
    assert iters % 3 == 0 and iters < 512
    assert iters - 3 <= int(torch.nonzero(hist)[-1]) <= iters - 1
    assert int(hist[0]) == int((tls.tspan[:, 0] < tls.tspan[:, 1]).sum())
    want = float(hist.sum()) / (iters * tls.n)
    assert float(st["mean_active_frac"]) == pytest.approx(want, rel=1e-6)


def test_record_events_still_raises(scene):
    """A tape of 4 tests a lane leaves the photons as the trace without it
    leaves them, and every deposit is one of the lane's accepted tests, so
    counts >= deposits. (The name dates from when the tape was unported
    and this test checked that it raised; tests/test_torch_score_grad.py
    holds the tape against the reference.)"""
    (_, _, (tvol, ttf, ttfs), tls) = scene
    plain = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(0),
                                 TracerConfig())
    ph, ev = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(0),
                                  TracerConfig(), record_events=4)
    for f in ("positions", "powers", "directions", "exit_power",
              "exit_direction"):
        assert torch.equal(getattr(ph, f), getattr(plain, f)), f
    assert tuple(ev.types.shape) == (tls.n, 4)
    deposits = (ph.positions[..., 0] < 1e30).sum(0)
    assert bool((ev.counts >= deposits).all())
    assert int(ev.counts.max()) > 4 and int(deposits.sum()) > 0


# --- the options through the pipeline ---------------------------------------


def _pipeline(tracer_kw, recompute_kw=None):
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.sphere_in_box(32)),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create())
    tr = dict(max_interactions=2, max_steps=3000, **tracer_kw)
    rc = recompute_kw or {}
    kw = dict(photons_x=32, photons_y=32)
    jcfg = JPipelineConfig(tracer=JTracerConfig(**tr),
                           render=JRenderConfig(width=16, height=16),
                           recompute=JRecomputeConfig(**rc), **kw)
    tcfg = PipelineConfig(tracer=TracerConfig(**tr),
                          render=RenderConfig(width=16, height=16),
                          recompute=RecomputeConfig(**rc), **kw)
    state0 = jstep.init_state(scene, jcfg)
    tscene = convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                      device="cpu")
    return scene, jcfg, state0, tscene, tcfg


@pytest.fixture(scope="module")
def half():
    """The reference's float16 pipeline: its initial state and its full
    trace (budget a quarter, round-robin importance of a fifth)."""
    scene, jcfg, state0, tscene, tcfg = _pipeline(
        {"photon_dtype": "float16"},
        dict(max_photons_fraction=0.25, equal_importance=True,
             equal_importance_percentage=20))
    return (scene, jcfg, state0, jstep.full_trace_step(scene, state0, jcfg),
            tscene, tcfg)


def _frame_matches(scene, jcfg, state0, want, tscene, tcfg):
    """full_trace_step + render_state from the reference's initial state:
    light volume and image within 1% relative L1."""
    image = np.asarray(jstep.render_state(scene, want, jcfg))
    got = tstep.full_trace_step(
        tscene, convert.state_from_numpy(leaves_of(state0), device="cpu"),
        tcfg)
    timage = tstep.render_state(tscene, got, tcfg).numpy()
    lv, want_lv = got.light_volume.numpy(), np.asarray(want.light_volume)
    assert float(np.abs(want_lv).sum()) > 0.0
    assert rel_l1(lv, want_lv) < FRAME_REL_L1
    assert rel_l1(timage, image) < FRAME_REL_L1
    return got


def test_float16_frame_matches(half):
    got = _frame_matches(*half)
    assert got.photons.positions.dtype == torch.float16
    assert got.light_volume.dtype == torch.float32


def test_no_single_scattering_frame_matches():
    scene, jcfg, state0, tscene, tcfg = _pipeline(
        {"no_single_scattering": True})
    want = jstep.full_trace_step(scene, state0, jcfg)
    got = _frame_matches(scene, jcfg, state0, want, tscene, tcfg)
    assert int((got.photons.positions[..., 0] < 1e30).sum()) > 100


def test_float16_path_importance_reads_sentinels_in_float32(half):
    """The port's path importance of float16 photons is that of their
    widened values, held against the reference on those values. The
    reference's own float16 importance compares +inf with 1e30 in float16
    and turns most photons' importance to inf or NaN: not copied."""
    scene, jcfg, _, state, tscene, tcfg = half
    grid = jstep.build_importance_grid(scene, jcfg)
    broken = np.asarray(jstep.recompute_importance(
        jcfg, grid, state.photons, state.light_samples))
    assert not np.isfinite(broken).all()
    wide = state.photons.replace(
        positions=state.photons.positions.astype(jnp.float32),
        powers=state.photons.powers.astype(jnp.float32),
        directions=state.photons.directions.astype(jnp.float32))
    want = np.asarray(jstep.recompute_importance(jcfg, grid, wide,
                                                 state.light_samples))
    tstate = convert.state_from_numpy(leaves_of(state), device="cpu")
    assert tstate.photons.positions.dtype == torch.float16
    tgrid = tstep.build_importance_grid(tscene, tcfg)
    got = tstep.recompute_importance(tcfg, tgrid, tstate.photons,
                                     tstate.light_samples).numpy()
    assert np.isfinite(got).all() and (got > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_float16_correlated_step_matches_reference(half):
    """One float16 correlated step after a TF edit from the reference's
    float16 state, with round-robin importance (a fifth of the photons,
    so the selection does not read the photons): the same photons are
    retraced, the photons stay float16, and the light volume is within
    1% of the reference's."""
    scene, jcfg, _, state, _, tcfg = half
    pos, col = synthetic.default_tf_points()
    col = np.asarray(col, np.float32).copy()
    col[:, 3] = np.clip(col[:, 3] * 1.6, 0.0, 1.0)
    edited = scene.replace(tf=jtypes.TransferFunction.from_points(pos, col))
    tedited = convert.scene_from_numpy(leaves_of(edited), edited.lights,
                                       device="cpu")
    tstate = convert.state_from_numpy(leaves_of(state), device="cpu")
    jgrid = jstep.build_importance_grid(edited, jcfg)
    tgrid = tstep.build_importance_grid(tedited, tcfg)
    budget = jstep.recompute_budget(jcfg, 1024)
    want = jstep.correlated_step(edited, state, jcfg, jgrid, budget)
    got = tstep.correlated_step(tedited, tstate, tcfg, tgrid, budget)
    assert got.photons.positions.dtype == torch.float16
    assert np.asarray(want.photons.positions).dtype == np.float16
    np.testing.assert_array_equal(got.retraced.numpy(),
                                  np.asarray(want.retraced))
    assert got.n_remaining == int(want.n_remaining) == 0
    lv, want_lv = got.light_volume.numpy(), np.asarray(want.light_volume)
    moved = rel_l1(want_lv, np.asarray(state.light_volume))
    assert moved > 10 * FRAME_REL_L1
    assert rel_l1(lv, want_lv) < FRAME_REL_L1


def test_float16_drain_equals_full_retrace():
    """A grid of ones drained in 50% batches on float16 photons equals the
    float16 full trace: photons bit for bit, the light volume within the
    ±1 residue (tests/test_pipeline.py:136-138)."""
    scene, jcfg, state0, tscene, tcfg = _pipeline(
        {"photon_dtype": "float16"}, dict(max_photons_fraction=0.5))
    full = tstep.full_trace_step(
        tscene, tstep.init_state(tscene, tcfg), tcfg)
    stale = tstep.full_trace_step(
        tscene, tstep.init_state(tscene, tcfg, seed=1), tcfg)
    stale = dataclasses.replace(stale, key=full.key)
    grid = tstep.build_importance_grid(tscene, tcfg)
    ones = dataclasses.replace(grid, data=torch.ones_like(grid.data))
    budget = tstep.recompute_budget(tcfg, full.photons.n)
    s = tstep.correlated_step(tscene, stale, tcfg, ones, budget)
    s = tstep.correlated_step(tscene, s, tcfg, ones, budget)
    assert s.n_remaining == 0
    for f in FIELDS:
        assert torch.equal(getattr(s.photons, f), getattr(full.photons, f)), f
    torch.testing.assert_close(s.light_volume, full.light_volume, rtol=1e-3,
                               atol=1e-3)

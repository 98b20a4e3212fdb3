"""The port's Woodcock tracer against the JAX reference, lane by lane from
the same light samples and key, plus the reference's free-flight physics
and bookkeeping checks run on the port (CPU, 16^3 volumes)."""

import jax
import numpy as np
import pytest
import torch

from cpm_tpu.core import constants
from cpm_tpu.core import lights as jlights
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import phase as jphase
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import TracerConfig
from cpm_tpu_torch.ops import emit, rng, sampling, tracer

# Lane-by-lane tolerance: XLA and torch round log/exp differently, and a
# last-ulp difference can flip one Woodcock acceptance and send that lane
# elsewhere; so 95% of lanes must agree to 1e-4 in position and power.
LANE_POS_ATOL = 1e-4
LANE_POW_RTOL = 1e-4
MIN_LANE_FRACTION = 0.95

CASES = {
    "default": dict(max_interactions=2, max_steps=1200),
    "hg_one_flight": dict(max_interactions=3, max_steps=1200,
                          phase_type=jphase.HENYEY_GREENSTEIN, phase_g=0.5,
                          flights_per_iteration=1),
    "clip_ring2": dict(max_interactions=2, max_steps=1200, block_ring=2,
                       clip_min=(0.1, 0.0, 0.2), clip_max=(0.9, 1.0, 0.8)),
}


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


def _lane_agreement(jph, tph):
    """Per lane: same used slots, positions within LANE_POS_ATOL and
    powers within LANE_POW_RTOL."""
    jp, tp = np.asarray(jph.positions), tph.positions.numpy()
    jw, tw = np.asarray(jph.powers), tph.powers.numpy()
    used = jp[..., 0] < 1e30
    same_slots = np.all(used == (tp[..., 0] < 1e30), axis=0)
    pos_ok = np.all(np.where(used[..., None], np.abs(jp - tp), 0.0)
                    <= LANE_POS_ATOL, axis=(0, 2))
    pow_ok = np.all(np.isclose(tw, jw, rtol=LANE_POW_RTOL, atol=0.0),
                    axis=(0, 2))
    return same_slots & pos_ok & pow_ok, used


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches_reference_lane_by_lane(scene, case):
    (jvol, jtf, jtfs), jls, (tvol, ttf, ttfs), tls = scene
    kw = CASES[case]
    jph = jtracer.trace_photons(jvol, jtf, jtfs, jls,
                                jax.random.PRNGKey(11), JTracerConfig(**kw))
    tph = tracer.trace_photons(tvol, ttf, ttfs, tls, rng.prng_key(11),
                               TracerConfig(**kw))
    ok, used = _lane_agreement(jph, tph)
    frac = float(ok.mean())
    print(f"{case}: {frac:.4f} of {ok.size} lanes agree; "
          f"{int(used.sum())} reference deposits")
    assert used.sum() > 100
    assert frac >= MIN_LANE_FRACTION
    # The lanes that agree also agree on their exit bookkeeping.
    np.testing.assert_allclose(tph.exit_direction.numpy()[ok],
                               np.asarray(jph.exit_direction)[ok],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tph.exit_power.numpy()[ok],
                               np.asarray(jph.exit_power)[ok], rtol=1e-4)
    np.testing.assert_allclose(tph.directions.numpy()[:, ok],
                               np.asarray(jph.directions)[:, ok],
                               rtol=1e-4, atol=1e-4)
    assert tph.radius_rel == pytest.approx(float(jph.radius_rel), rel=1e-7)


def _homogeneous(opacity, albedo, dim=16):
    vol = ttypes.Volume.from_data(np.ones((dim, dim, dim), np.float32),
                                 device="cpu")
    tf = ttypes.TransferFunction.from_points(
        [0.0, 1.0], [(1, 1, 1, opacity), (1, 1, 1, opacity)], device="cpu")
    scat_w = opacity * albedo / (1.0 - albedo)
    tfs = ttypes.TransferFunction.from_points(
        [0.0, 1.0], [(1, 1, 1, scat_w), (1, 1, 1, scat_w)], device="cpu")
    return vol, tf, tfs


def _trace(n=4096, opacity=0.5, albedo=0.9, max_i=1, seed=0):
    vol, tf, tfs = _homogeneous(opacity, albedo)
    side = int(np.sqrt(n))
    ls = emit.emit(jlights.Light.directional([0.0, 0.0, 1.0]),
                   sampling.stratified_grid_2d(side, side, device="cpu"))
    ph = tracer.trace_photons(vol, tf, tfs, ls, rng.prng_key(seed),
                              TracerConfig(max_interactions=max_i))
    return ph, ls


def test_interaction_fraction_matches_beer_lambert():
    """P(interact within unit depth) = 1 - exp(-sigma); tolerance 0.02
    (tests/test_tracer.py)."""
    opacity = 0.3
    ph, _ = _trace(n=16384, opacity=opacity)
    interacted = ph.positions[0, :, 0].numpy() < 1e30
    sigma = opacity * constants.SAMPLING_BASE_INTERVAL_RCP
    assert interacted.mean() == pytest.approx(1.0 - np.exp(-sigma), abs=0.02)


def test_first_interaction_depth_distribution():
    """Mean depth of a truncated exponential on [0, 1]; tolerance 5%
    (tests/test_tracer.py)."""
    opacity = 0.2
    ph, _ = _trace(n=16384, opacity=opacity)
    pos = ph.positions[0].numpy()
    depth = pos[pos[:, 0] < 1e30, 2]
    sigma = opacity * constants.SAMPLING_BASE_INTERVAL_RCP
    want = 1.0 / sigma - np.exp(-sigma) / (1 - np.exp(-sigma))
    assert depth.mean() == pytest.approx(want, rel=0.05)


def test_absorbed_photon_power():
    """Stored power = power0 / maxI / max(opacity, 0.01); an absorbed path
    exits with the FLT_MAX sentinel."""
    opacity = 0.5
    ph, ls = _trace(n=1024, opacity=opacity, albedo=1e-6)
    ok = ph.positions[0, :, 0].numpy() < 1e30
    assert ok.sum() > 100
    np.testing.assert_allclose(ph.powers[0].numpy()[ok],
                               ls.powers.numpy()[ok] / opacity, rtol=1e-4)
    assert np.all(ph.exit_power.numpy()[ok] > 1e30)


def test_sentinels_fill_slots_in_order_and_are_deterministic():
    a, _ = _trace(n=1024, opacity=0.4, albedo=0.6, max_i=4, seed=3)
    b, _ = _trace(n=1024, opacity=0.4, albedo=0.6, max_i=4, seed=3)
    filled = a.positions[..., 0].numpy() < 1e30
    counts = filled.sum(0)
    for i in range(4):
        assert np.all(filled[i] == (counts > i))
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.powers, b.powers)
    pos = a.positions.numpy()[filled]
    assert np.all((pos >= -1e-4) & (pos <= 1 + 1e-4))


@pytest.mark.parametrize("what", ["record_events"])
def test_unported_options_raise(what):
    """The event tape's per-lane test counts equal the reference's, lane
    for lane, on an 8^3 homogeneous scene. (The name dates from when the
    tape was the one option left unported and this case checked that it
    raised; tests/test_torch_score_grad.py holds the whole tape.)"""
    vol, tf, tfs = _homogeneous(0.5, 0.9, dim=8)
    ls = emit.emit(jlights.Light.directional([0.0, 0.0, 1.0]),
                   sampling.stratified_grid_2d(4, 4, device="cpu"))
    ph, events = tracer.trace_photons(vol, tf, tfs, ls, rng.prng_key(0),
                                      TracerConfig(), **{what: 8})
    jargs = (jtypes.Volume.from_data(vol.data.numpy()),
             *(jtypes.TransferFunction.from_points(t.positions.numpy(),
                                                   t.colors.numpy())
               for t in (tf, tfs)))
    jls = jtypes.LightSamples(
        **{f: np.asarray(getattr(ls, f)) for f in ("origins", "directions",
                                                   "powers", "tspan")},
        iteration=np.int32(0))
    _, jevents = jtracer.trace_photons(*jargs, jls, jax.random.PRNGKey(0),
                                       JTracerConfig(), **{what: 8})
    np.testing.assert_array_equal(events.counts.numpy(),
                                  np.asarray(jevents.counts))
    assert int(events.counts.max()) > 0

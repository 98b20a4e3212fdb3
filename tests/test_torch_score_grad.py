"""The port's event tape and score-function trajectory gradients
(``ops/tracer.py`` with ``record_events``, ``ops/score_grad.py``) against
the JAX reference and the reference tests' independent oracles, on
collimated beams of 2^12-2^14 lanes through 8^3 volumes
(tests/test_score_grad.py's scenes).

Tolerances: the tape's types and counts bit for bit on every lane whose
trajectory did not diverge (XLA and torch round log/exp differently, so a
last-ulp difference may flip one acceptance; at most 1% of lanes may);
positions to 1e-5 (texture units) and majorants to rtol 1e-6 there. The
estimator on the reference's own photons and tape: value to rtol 1e-5,
gradients to rtol 1e-4 with an absolute floor of 1e-5 of the largest
component (float32 sums over 16k lanes in another order). The closed-form
oracle: 2% on the value, 5% on the derivative, as the reference's test.
The Euler identity: rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.core.types import LightSamples as JLightSamples
from cpm_tpu.core.types import TransferFunction as JTF
from cpm_tpu.core.types import Volume as JVolume
from cpm_tpu.ops import score_grad as jscore
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu_torch.core import constants
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import TracerConfig
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import replay, rng, score_grad, tracer

SBI = constants.SAMPLING_BASE_INTERVAL_RCP
MAX_DIVERGED = 0.01
POS_ATOL, MAJ_RTOL = 1e-5, 1e-6
# Beside JAX's thread pool torch's own costs several times over.
torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5


def _carry(jph, jls, jev):
    """The reference's photons, light samples and tape as the port's, on
    the CPU."""
    def leaves(prefix, obj):
        return {f"{prefix}.{f}": np.asarray(v)
                for f, v in obj.__dict__.items()}

    return (convert.photons_from_numpy(leaves("photons", jph), device="cpu"),
            convert.samples_from_numpy(leaves("light_samples", jls),
                                       device="cpu"),
            convert.events_from_numpy(
                {f"events.{f}": np.asarray(v)
                 for f, v in jev._asdict().items()}, device="cpu"))


def _beam(n, p0=1.0):
    """Collimated beam straight down: origins on y = 1, spans to y = 0 (as
    numpy, handed to both packages)."""
    xs = (np.arange(n, dtype=np.float32) + 0.5) / n
    return dict(
        origins=np.stack([xs * 0.8 + 0.1, np.ones(n, np.float32),
                          np.full(n, 0.5, np.float32)], axis=-1),
        directions=np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1)),
        powers=np.full((n, 3), p0, np.float32),
        tspan=np.tile(np.array([[0.0, 1.0]], np.float32), (n, 1)))


def _ramp(dim):
    return np.broadcast_to(((np.arange(dim) + 0.5) / dim)[None, :, None],
                           (dim, dim, dim)).astype(np.float32)


# name: (volume, TF points, scattering TF points, lanes, tracer options)
SCENES = {
    "homogeneous": (np.full((8, 8, 8), 0.5, np.float32),
                    ([0.0, 1.0], [(1, 1, 1, 0.02), (1, 1, 1, 0.02)]),
                    ([0.0, 1.0], [(1, 1, 1, 0.5), (1, 1, 1, 0.5)]), 1 << 14,
                    dict(max_interactions=1, tau_max=0.06)),
    "ramp_two_interactions": (
        _ramp(8), ([0.0, 1.0], [(1, 1, 1, 0.0), (1, 1, 1, 0.03)]),
        ([0.0, 1.0], [(1, 1, 1, 0.03), (1, 1, 1, 0.03)]), 1 << 12,
        dict(max_interactions=2, tau_max=0.08)),
    "ramp_no_single_scattering": (
        _ramp(8), ([0.0, 1.0], [(1, 1, 1, 0.0), (1, 1, 1, 0.03)]),
        ([0.0, 1.0], [(1, 1, 1, 0.03), (1, 1, 1, 0.03)]), 1 << 12,
        dict(max_interactions=2, tau_max=0.08, no_single_scattering=True)),
}
COMMON = dict(max_steps=4000, use_majorant_grid=False, use_compaction=False,
              flights_per_iteration=1)
E = 96


def _both(name, seed):
    """The reference's and the port's (volume, tf, tfs, samples, config)
    of a scene, and both traces with a tape of E tests."""
    data, tfp, tfsp, n, opts = SCENES[name]
    beam = _beam(n)
    jargs = (JVolume.from_data(jnp.asarray(data)), JTF.from_points(*tfp),
             JTF.from_points(*tfsp),
             JLightSamples(**{k: jnp.asarray(v) for k, v in beam.items()},
                           iteration=jnp.int32(0)))
    targs = (ttypes.Volume.from_data(data, device="cpu"),
             ttypes.TransferFunction.from_points(*tfp, device="cpu"),
             ttypes.TransferFunction.from_points(*tfsp, device="cpu"),
             ttypes.LightSamples(**{k: torch.from_numpy(v)
                                    for k, v in beam.items()}))
    jph, jev = jtracer.trace_photons(*jargs, jax.random.PRNGKey(seed),
                                     JTracerConfig(**COMMON, **opts),
                                     record_events=E)
    tph, tev = tracer.trace_photons(*targs, rng.prng_key(seed),
                                    TracerConfig(**COMMON, **opts),
                                    record_events=E)
    return jargs, targs, (jph, jev), (tph, tev)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tape_matches_reference(name):
    _, _, (_, jev), (_, tev) = _both(name, seed=0)
    jt, tt = np.asarray(jev.types), tev.types.numpy()
    jc, tc = np.asarray(jev.counts), tev.counts.numpy()
    same = (jc == tc) & np.all(jt == tt, axis=1)
    assert 1.0 - same.mean() <= MAX_DIVERGED, 1.0 - same.mean()
    assert tc.max() <= E and (tc > 1).sum() > 100
    kinds = set(np.unique(tt[same]).tolist())
    want = ({jtracer.EVT_NULL, jtracer.EVT_FIRST}
            if "no_single" in name else {jtracer.EVT_NULL})
    assert want <= kinds, kinds
    np.testing.assert_allclose(tev.positions.numpy()[same],
                               np.asarray(jev.positions)[same], rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(tev.majorants.numpy()[same],
                               np.asarray(jev.majorants)[same],
                               rtol=MAJ_RTOL)


def test_tape_codes_match_reference():
    assert (tracer.EVT_NULL, tracer.EVT_SCATTER, tracer.EVT_ABSORB,
            tracer.EVT_FORCED, tracer.EVT_FIRST) == (
        jtracer.EVT_NULL, jtracer.EVT_SCATTER, jtracer.EVT_ABSORB,
        jtracer.EVT_FORCED, jtracer.EVT_FIRST)


def test_statistics_take_precedence_over_the_tape():
    """As the reference's return: with both options on, (photons, stats)."""
    _, targs, _, (tph, _) = _both("ramp_two_interactions", seed=1)
    data, tfp, tfsp, n, opts = SCENES["ramp_two_interactions"]
    ph, stats = tracer.trace_photons(*targs, rng.prng_key(1),
                                     TracerConfig(**COMMON, **opts),
                                     return_stats=True, record_events=E)
    assert isinstance(stats, dict) and stats["wavefront_iters"] > 0
    assert torch.equal(ph.positions, tph.positions)


def _y_weighted_loss(photons, n):
    pos = photons.positions.detach()
    w_y = torch.where(pos[..., 0] < 1e30, pos[..., 1], 0.0)

    def loss(dep):
        return (dep.sum(-1) * w_y).sum() / n

    return loss


def test_trajectory_gradients_match_reference_on_its_tape():
    """The full estimator from the reference's photons and tape carried
    across, every leaf against ``jax.grad``."""
    jargs, targs, (jph, jev), _ = _both("homogeneous", seed=0)
    n = SCENES["homogeneous"][3]
    tph, tls, tev = _carry(jph, jargs[3], jev)
    jpos = jax.lax.stop_gradient(jph.positions)
    jw = jnp.where(jpos[..., 0] < 1e30, jpos[..., 1], 0.0)
    jval, jg = jscore.trajectory_gradients(
        *jargs, jph, jev, lambda dep: jnp.sum(jnp.sum(dep, -1) * jw) / n)
    val, g = score_grad.trajectory_gradients(
        *targs[:3], tls, tph, tev, _y_weighted_loss(tph, n))
    np.testing.assert_allclose(float(val), float(jval), rtol=VALUE_RTOL)
    want = {"volume.data": jg[0].data, "tf.positions": jg[1].positions,
            "tf.colors": jg[1].colors,
            "tf_scattering.positions": jg[2].positions,
            "tf_scattering.colors": jg[2].colors,
            "light_samples.powers": jg[3].powers}
    assert set(g) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            g[name].numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_REL * max(np.abs(w).max(), 1e-30), err_msg=name)
    assert np.abs(np.asarray(jg[1].colors[:, 3])).max() > 0.0


def test_full_gradient_matches_closed_form_and_replay_does_not():
    """tests/test_score_grad.py's analytic case on the port's own trace:
    homogeneous medium, one interaction; E(theta) = C / theta *
    I(theta * sbi) in float64, its derivative by central differences."""
    theta0 = 0.02
    _, (vol, tf, tfs, ls), _, (ph, ev) = _both("homogeneous", seed=0)
    n = ls.n
    assert int(ev.counts.max()) <= E
    t, c = ev.types.numpy(), ev.counts.numpy()
    assert (t[c > 1] == tracer.EVT_NULL).any()
    loss = _y_weighted_loss(ph, n)
    val, g = score_grad.trajectory_gradients(vol, tf, tfs, ls, ph, ev, loss)
    g_full = float(g["tf.colors"][:, 3].sum())

    def tf_const(theta):
        cols = torch.ones(2, 4)
        cols[:, 3] = theta
        return ttypes.TransferFunction.from_points([0.0, 1.0], cols,
                                                   device="cpu")

    theta = torch.tensor(theta0, requires_grad=True)
    g_path, = torch.autograd.grad(
        loss(replay.replay_powers(vol, tf_const(theta), tfs, ph, ls)), theta)

    def closed(th):
        s = th * SBI
        integral = (1.0 - np.exp(-s)) - (1.0 - np.exp(-s) * (1.0 + s)) / s
        return 3.0 / th * integral

    h = 1e-6
    d_true = (closed(theta0 + h) - closed(theta0 - h)) / (2 * h)
    assert abs(float(val) - closed(theta0)) / closed(theta0) < 0.02
    assert abs(g_full - d_true) / abs(d_true) < 0.05, (g_full, d_true)
    assert abs(float(g_path) - d_true) / abs(d_true) > 0.25


def test_light_power_gradient_is_exact_euler_identity():
    """Deposits are linear in the emitted power and the trajectories do
    not depend on it: <powers, dL/dpowers> = L."""
    data, tfp, tfsp, _, opts = SCENES["homogeneous"]
    beam = _beam(1 << 12, p0=2.0)
    vol = ttypes.Volume.from_data(data, device="cpu")
    tf = ttypes.TransferFunction.from_points(*tfp, device="cpu")
    tfs = ttypes.TransferFunction.from_points(*tfsp, device="cpu")
    ls = ttypes.LightSamples(**{k: torch.from_numpy(v)
                                for k, v in beam.items()})
    ph, ev = tracer.trace_photons(vol, tf, tfs, ls, rng.prng_key(0),
                                  TracerConfig(**COMMON, **opts),
                                  record_events=64)
    val, g = score_grad.trajectory_gradients(
        vol, tf, tfs, ls, ph, ev, _y_weighted_loss(ph, ls.n))
    euler = float((g["light_samples.powers"].double()
                   * ls.powers.double()).sum())
    np.testing.assert_allclose(euler, float(val), rtol=1e-5)

"""The port's differentiable replay (``ops/replay.py``) and trajectory
log-probability (``ops/score_grad.log_prob_lanes``) against the JAX
reference, on the reference's photons and event tape carried across with
``io/convert.py``, at the reference tests' size (16^3 smoke cloud, 16^2
light samples, 3 interactions); and the replay of the port's own trace.

Tolerances: values to rtol 1e-5 (float32 arithmetic in another order);
gradients to rtol 1e-4 with an absolute floor of 1e-5 of the largest
component (float32 sums of a few hundred lanes). The replay against the
tracer's stored powers: rtol 2e-5, as tests/test_grad.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.core.lights import Light as JLight
from cpm_tpu.core.types import TransferFunction as JTF
from cpm_tpu.core.types import Volume as JVolume
from cpm_tpu.io import synthetic
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import replay as jreplay
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.ops import score_grad as jscore
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import TracerConfig
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import replay, rng, score_grad, tracer

# Beside JAX's thread pool torch's own costs several times over.
torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
TRACED_RTOL, TRACED_ATOL = 2e-5, 1e-8

DIM = 16
TF_POS = np.array([0.0, 0.25, 0.6, 1.0], np.float32)
TF_COLS = np.array([[0.1, 0.2, 0.3, 0.05], [0.4, 0.5, 0.3, 0.3],
                    [0.9, 0.7, 0.5, 0.6], [1.0, 1.0, 1.0, 0.9]], np.float32)
SC_POS = np.array([0.0, 1.0], np.float32)
SC_COLS = np.array([[1.0, 1.0, 1.0, 0.7], [1.0, 1.0, 1.0, 0.9]], np.float32)
CFG = dict(max_interactions=3, max_steps=1500, use_compaction=False)
E = 64


def leaves(prefix: str, obj, fields) -> dict:
    return {f"{prefix}.{f}": np.asarray(getattr(obj, f)) for f in fields}


PHOTON_FIELDS = ("positions", "powers", "directions", "exit_power",
                 "exit_direction", "radius_rel", "scene_radius", "iteration")
SAMPLE_FIELDS = ("origins", "directions", "powers", "tspan", "iteration")
EVENT_FIELDS = ("positions", "majorants", "types", "counts")


def carry(jph, jls, jev=None):
    """The reference's photons, light samples and tape as the port's, on
    the CPU."""
    out = (convert.photons_from_numpy(leaves("photons", jph, PHOTON_FIELDS),
                                      device="cpu"),
           convert.samples_from_numpy(
               leaves("light_samples", jls, SAMPLE_FIELDS), device="cpu"))
    if jev is not None:
        out += (convert.events_from_numpy(
            leaves("events", jev, EVENT_FIELDS), device="cpu"),)
    return out


@pytest.fixture(scope="module")
def setup():
    data = synthetic.smoke_cloud(DIM, seed=5)
    jvol = JVolume.from_data(data)
    jtf, jtfs = (JTF.from_points(TF_POS, TF_COLS),
                 JTF.from_points(SC_POS, SC_COLS))
    jls = jemit.emit(JLight.directional((0.2, -1.0, 0.3)),
                     jsampling.stratified_grid_2d(16, 16))
    jph, jev = jtracer.trace_photons(jvol, jtf, jtfs, jls,
                                     jax.random.PRNGKey(3),
                                     JTracerConfig(**CFG), record_events=E)
    tph, tls, tev = carry(jph, jls, jev)
    port = (ttypes.Volume.from_data(data, device="cpu"),
            ttypes.TransferFunction.from_points(TF_POS, TF_COLS,
                                                device="cpu"),
            ttypes.TransferFunction.from_points(SC_POS, SC_COLS,
                                                device="cpu"))
    return (jvol, jtf, jtfs, jls, jph, jev), (*port, tls, tph, tev)


def test_events_carry_across_with_their_types(setup):
    (*_, jev), (*_, tev) = setup
    assert tev.positions.dtype == tev.majorants.dtype == torch.float32
    assert tev.types.dtype == tev.counts.dtype == torch.int32
    assert tuple(tev.types.shape) == (256, E)
    np.testing.assert_array_equal(tev.types.numpy(), np.asarray(jev.types))
    assert int(tev.counts.max()) <= E


def test_replay_matches_reference_and_the_traced_powers(setup):
    (jvol, jtf, jtfs, jls, jph, _), (vol, tf, tfs, ls, ph, _) = setup
    want = np.asarray(jreplay.replay_powers(jvol, jtf, jtfs, jph, jls))
    got = replay.replay_powers(vol, tf, tfs, ph, ls).numpy()
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL, atol=1e-9)
    dep = ph.positions[..., 0].numpy() < 1e30
    assert dep.sum() > 50
    np.testing.assert_allclose(got[dep], ph.powers.numpy()[dep],
                               rtol=TRACED_RTOL, atol=TRACED_ATOL)
    np.testing.assert_array_equal(got[~dep], 0.0)


def test_replay_of_the_ports_own_trace_matches_its_powers(setup):
    _, (vol, tf, tfs, ls, _, _) = setup
    ph = tracer.trace_photons(vol, tf, tfs, ls, rng.prng_key(3),
                              TracerConfig(**CFG))
    got = replay.replay_photons(vol, tf, tfs, ph, ls).powers.numpy()
    dep = ph.positions[..., 0].numpy() < 1e30
    assert dep.sum() > 50
    np.testing.assert_allclose(got[dep], ph.powers.numpy()[dep],
                               rtol=TRACED_RTOL, atol=TRACED_ATOL)
    np.testing.assert_array_equal(got[~dep], 0.0)


def test_replay_of_float16_photons_reads_their_sentinels(setup):
    """float16 storage turns FLT_MAX into +inf: still an unused slot."""
    _, (vol, tf, tfs, ls, ph, _) = setup
    half = dataclasses.replace(ph, positions=ph.positions.half())
    got = replay.replay_powers(vol, tf, tfs, half, ls)
    assert bool(torch.isfinite(got).all())
    dep = ph.positions[..., 0] < 1e30
    assert torch.equal(got[~dep], torch.zeros_like(got[~dep]))


def _jax_grads(fn, jvol, jtf, jtfs, jls):
    g = jax.grad(fn, argnums=(0, 1, 2, 3))(jvol.data, jtf.colors,
                                            jtfs.colors, jls.powers)
    return [np.asarray(x) for x in g]


def _port_grads(fn, vol, tf, tfs, ls):
    xs = [t.detach().clone().requires_grad_(True)
          for t in (vol.data, tf.colors, tfs.colors, ls.powers)]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, allow_unused=True)
    return float(out.detach()), [np.zeros(x.shape, np.float32) if g is None
                                 else g.numpy() for x, g in zip(xs, grads)]


def _close_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * np.abs(w).max())
        assert np.abs(w).max() > 0


def test_replay_gradients_match_jax_grad(setup):
    """A weighted sum of the replayed powers, differentiated with respect
    to the volume, both TFs' colours and the light powers."""
    (jvol, jtf, jtfs, jls, jph, _), (vol, tf, tfs, ls, ph, _) = setup
    w = np.random.default_rng(0).uniform(0.5, 1.5, ph.powers.shape).astype(
        np.float32)

    def jloss(data, cols, scols, powers):
        return jnp.sum(w * jreplay.replay_powers(
            jvol.replace(data=data), JTF.from_points(TF_POS, cols),
            JTF.from_points(SC_POS, scols), jph, jls.replace(powers=powers)))

    def tloss(data, cols, scols, powers):
        return (torch.from_numpy(w) * replay.replay_powers(
            dataclasses.replace(vol, data=data),
            ttypes.TransferFunction.from_points(TF_POS, cols, device="cpu"),
            ttypes.TransferFunction.from_points(SC_POS, scols,
                                                device="cpu"),
            ph, dataclasses.replace(ls, powers=powers))).sum()

    val, got = _port_grads(tloss, vol, tf, tfs, ls)
    np.testing.assert_allclose(val, float(jloss(jvol.data, jtf.colors,
                                                jtfs.colors, jls.powers)),
                               rtol=VALUE_RTOL)
    _close_grads(got, _jax_grads(jloss, jvol, jtf, jtfs, jls))


def test_log_prob_lanes_matches_reference(setup):
    """Values on every lane, and the gradient of a weighted sum with
    respect to the volume and both TFs' colours (the light powers do not
    reach it)."""
    (jvol, jtf, jtfs, jls, _, jev), (vol, tf, tfs, ls, _, tev) = setup
    want = np.asarray(jscore.log_prob_lanes(jev, jvol, jtf, jtfs))
    got = score_grad.log_prob_lanes(tev, vol, tf, tfs).numpy()
    assert np.all(want <= 0.0) and (want < 0.0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL, atol=1e-6)
    w = np.linspace(0.5, 1.5, got.shape[0], dtype=np.float32)

    def jloss(data, cols, scols, powers):
        return jnp.sum(w * jscore.log_prob_lanes(
            jev, jvol.replace(data=data), JTF.from_points(TF_POS, cols),
            JTF.from_points(SC_POS, scols)))

    def tloss(data, cols, scols, powers):
        return (torch.from_numpy(w) * score_grad.log_prob_lanes(
            tev, dataclasses.replace(vol, data=data),
            ttypes.TransferFunction.from_points(TF_POS, cols, device="cpu"),
            ttypes.TransferFunction.from_points(SC_POS, scols,
                                                device="cpu"))).sum()

    _, got = _port_grads(tloss, vol, tf, tfs, ls)
    want = _jax_grads(jloss, jvol, jtf, jtfs, jls)
    _close_grads(got[:3], want[:3])
    assert not got[3].any() and not want[3].any()


def test_log_prob_leaves_out_overflowed_lanes(setup):
    """A lane whose tape holds fewer tests than it made gives 0."""
    _, (vol, tf, tfs, _, _, tev) = setup
    cut = tev._replace(counts=tev.counts + E + 1)
    assert not score_grad.log_prob_lanes(cut, vol, tf, tfs).any()


def test_replay_rejects_no_single_scattering(setup):
    _, (vol, tf, tfs, ls, ph, _) = setup
    with pytest.raises(NotImplementedError, match="no_single_scattering"):
        replay.replay_powers(vol, tf, tfs, ph, ls, no_single_scattering=True)

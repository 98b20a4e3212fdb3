"""The port's next-event estimation (``ops/nee.py``) against the JAX
reference for every light type, and the reference's own checks
(tests/test_nee.py) on the port (CPU, 64 query points, a 24^3 sphere)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import lights as jlights
from cpm_tpu.core import types as jtypes
from cpm_tpu.io import synthetic
from cpm_tpu.ops import nee as jnee
from cpm_tpu_torch.core import lights as tlights
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.ops import nee, rng

# The same float32 formulas in two frameworks.
RTOL, ATOL = 1e-5, 1e-6

LIGHTS = {
    "directional": ("directional", ((0.2, -1.0, 0.3),),
                    dict(radiance=(1.0, 0.5, 0.25))),
    "point": ("point", ((0.5, 0.9, 0.5),), dict(radiance=(2.0, 1.0, 0.5))),
    "cone": ("cone", ((0.5, 1.4, 0.5), (0.0, -1.0, 0.1)),
             dict(cos_fov=0.95)),
    "area": ("area", ((0.5, 1.4, 0.5), (0.0, -1.0, 0.0)),
             dict(size=(0.5, 0.25))),
    "area_z": ("area", ((0.5, 0.5, -0.4), (0.0, 0.0, 1.0)), {}),
}


def _lights(name):
    fn, args, kw = LIGHTS[name]
    return (getattr(jlights.Light, fn)(*args, **kw),
            getattr(tlights.Light, fn)(*args, **kw))


def _pts(n=64, seed=0):
    return np.random.RandomState(seed).rand(n, 3).astype(np.float32)


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("name", sorted(LIGHTS))
def test_sample_light_toward_matches(name, keyed):
    jl, tl = _lights(name)
    p = _pts()
    jkey = jax.random.PRNGKey(5) if keyed else None
    tkey = rng.prng_key(5) if keyed else None
    want = jnee.sample_light_toward(jl, jnp.asarray(p), jkey)
    got = nee.sample_light_toward(tl, torch.from_numpy(p), tkey)
    for w, g, what in zip(want, got, ("wi", "power", "pdf", "origin")):
        assert tuple(g.shape) == tuple(np.shape(w)), what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=what)
    if name.startswith("area") and keyed:
        # The points on the quad are jax.random.uniform's draws: the
        # origins spread over the quad, as the reference's.
        assert float(got[3].std(dim=0).max()) > 0.05


def test_area_uv_is_jax_uniform_word_for_word():
    """Without a key the quad's centre; with one, uv = uniform(key, (N, 2))
    bit for bit, so the origins equal the reference's to float32."""
    _, tl = _lights("area")
    p = _pts(16)
    key = rng.prng_key(9)
    uv = rng.uniform(key, (16, 2), device="cpu").numpy()
    np.testing.assert_array_equal(
        uv, np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (16, 2))))
    _, _, _, centre = nee.sample_light_toward(tl, torch.from_numpy(p))
    np.testing.assert_allclose(centre.numpy(),
                               np.broadcast_to((0.5, 1.4, 0.5), (16, 3)),
                               atol=1e-6)


def test_point_inverse_square():
    light = tlights.Light.point((0.5, 0.5, 0.5), radiance=(2.0, 1.0, 0.5))
    p = torch.from_numpy(_pts())
    wi, power, pdf, _ = nee.sample_light_toward(light, p)
    d = np.linalg.norm(p.numpy() - 0.5, axis=1)
    np.testing.assert_allclose(power[:, 0].numpy(),
                               2.0 / np.maximum(d * d, 1e-12), rtol=1e-4)
    np.testing.assert_allclose(pdf.numpy(), 1.0)
    np.testing.assert_allclose(
        wi.numpy(), (p.numpy() - 0.5) / np.maximum(d, 1e-9)[:, None],
        atol=1e-5)


def test_cone_aperture_zeroes_outside():
    light = tlights.Light.cone((0.5, 0.5, -1.0), (0.0, 0.0, 1.0),
                               cos_fov=np.cos(np.deg2rad(10.0)))
    on = torch.tensor([[0.5, 0.5, 0.5]])
    off = torch.tensor([[0.95, 0.5, 0.0]])
    _, pw_on, pdf_on, _ = nee.sample_light_toward(light, on)
    _, pw_off, pdf_off, _ = nee.sample_light_toward(light, off)
    assert float(pw_on[0, 0]) > 0 and float(pdf_on[0]) == 1.0
    assert float(pw_off[0, 0]) == 0.0 and float(pdf_off[0]) == 0.0


def test_area_pdf_geometry():
    light = tlights.Light(type=tlights.AREA, position=(0.5, 0.5, 0.0),
                          direction=(0.0, 0.0, 1.0), size=(0.2, 0.4))
    p = torch.tensor([[0.5, 0.5, 0.8]])
    _, _, pdf, origin = nee.sample_light_toward(light, p)
    np.testing.assert_allclose(origin[0].numpy(), [0.5, 0.5, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(float(pdf[0]), 0.8 ** 2 / (0.2 * 0.4),
                               rtol=1e-5)
    _, pw_b, pdf_b, _ = nee.sample_light_toward(
        light, torch.tensor([[0.5, 0.5, -0.8]]))
    assert float(pdf_b[0]) == 0.0 and float(pw_b[0, 0]) == 0.0


@pytest.fixture(scope="module")
def sphere():
    data = synthetic.sphere_in_box(24, radius=0.25)
    tf = synthetic.default_tf_points()
    return ((jtypes.Volume.from_data(data),
             jtypes.TransferFunction.from_points(*tf)),
            (ttypes.Volume.from_data(data, device="cpu"),
             ttypes.TransferFunction.from_points(*tf, device="cpu")))


def test_nee_single_scatter_attenuates(sphere):
    _, (vol, tf) = sphere
    light = tlights.Light.directional((0.0, 0.0, 1.0))
    front = nee.nee_single_scatter(light, vol, tf,
                                   torch.tensor([[0.5, 0.5, 0.1]]))
    behind = nee.nee_single_scatter(light, vol, tf,
                                    torch.tensor([[0.5, 0.5, 0.9]]))
    assert float(front[0, 0]) > 5.0 * float(behind[0, 0])


@pytest.mark.parametrize("name", sorted(LIGHTS))
def test_nee_single_scatter_matches(sphere, name):
    (jvol, jtf), (tvol, ttf) = sphere
    jl, tl = _lights(name)
    p = _pts(48, seed=3)
    want = np.asarray(jnee.nee_single_scatter(
        jl, jvol, jtf, jnp.asarray(p), jax.random.PRNGKey(2), n_steps=32))
    got = nee.nee_single_scatter(tl, tvol, ttf, torch.from_numpy(p),
                                 rng.prng_key(2), n_steps=32)
    assert got.shape == (48, 3)
    assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)

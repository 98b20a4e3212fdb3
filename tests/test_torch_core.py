"""Parity of the port's core types, RNG, intersection, sampling, emission,
phase sampling and host-side scene setup with the JAX reference (CPU,
small inputs from numpy seeds)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import camera as jcamera
from cpm_tpu.core import config as jconfig
from cpm_tpu.core import lights as jlights
from cpm_tpu.core import types as jtypes
from cpm_tpu.io import synthetic as jsynthetic
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import intersect as jintersect
from cpm_tpu.ops import phase as jphase
from cpm_tpu.ops import rng as jrng
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu_torch.core import camera as tcamera
from cpm_tpu_torch.core import config as tconfig
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.ops import emit as temit
from cpm_tpu_torch.ops import intersect as tintersect
from cpm_tpu_torch.ops import phase as tphase
from cpm_tpu_torch.ops import rng as trng
from cpm_tpu_torch.ops import sampling as tsampling

# Elementwise float32 math in two frameworks: a few ulps apart at most.
RTOL = ATOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# --- config -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["TracerConfig", "SplatConfig",
                                  "RecomputeConfig", "RenderConfig",
                                  "PipelineConfig"])
def test_config_fields_and_defaults_match(name):
    """Tolerance: equal names, order and default values."""
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert ([f.name for f in dataclasses.fields(tcls)]
            == [f.name for f in dataclasses.fields(jcls)])
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


# --- rng: bit-exact ---------------------------------------------------------

def test_threefry_words_bit_exact():
    rs = np.random.default_rng(0)
    k = rs.integers(0, 2 ** 32, 2, dtype=np.uint32)
    c0 = rs.integers(0, 2 ** 32, 257, dtype=np.uint32)
    c1 = rs.integers(0, 2 ** 32, 257, dtype=np.uint32)
    ja, jb = jrng.threefry2x32(k[0], k[1], jnp.asarray(c0), jnp.asarray(c1))
    ta, tb = trng.threefry2x32(int(k[0]), int(k[1]), t(c0.astype(np.int64)),
                               t(c1.astype(np.int64)))
    np.testing.assert_array_equal(ta.numpy().astype(np.uint32), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy().astype(np.uint32), np.asarray(jb))


@pytest.mark.parametrize("step,n_draws", [(0, 5), (7, 5), (123456, 4),
                                          (2 ** 31 + 5, 3)])
def test_uniforms_bit_exact(step, n_draws):
    key = jax.random.PRNGKey(42)
    k0, k1 = jrng.key_words(key)
    lanes = np.arange(0, 3000, 7, dtype=np.int32)
    want = jrng.uniforms(k0, k1, jnp.asarray(lanes),
                         jnp.uint32(step % 2 ** 32), n_draws)
    got = trng.uniforms(int(k0), int(k1), t(lanes), step, n_draws)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -12345])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    assert trng.prng_key(seed) == (int(want[0]), int(want[1]))


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in_matches_jax(data):
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    tkey = trng.fold_in(trng.prng_key(3), 1)
    want = np.asarray(jax.random.fold_in(jkey, data))
    assert trng.fold_in(tkey, data) == (int(want[0]), int(want[1]))


def test_prng_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        trng.prng_key(2 ** 31)


# --- types ------------------------------------------------------------------

TF_CASES = {
    "default": jsynthetic.default_tf_points(),
    "flat_step": ([0.0, 0.3, 0.35, 1.0],
                  [(0.2, 0.2, 0.2, 0.0), (0.2, 0.2, 0.2, 0.0),
                   (0.9, 0.8, 0.7, 0.5), (1.0, 1.0, 1.0, 0.8)]),
    "repeated_point": ([0.1, 0.4, 0.4, 0.9],
                       [(1.0, 0.0, 0.0, 0.1), (0.0, 1.0, 0.0, 0.4),
                        (0.0, 0.0, 1.0, 0.9), (1.0, 1.0, 1.0, 0.2)]),
}


@pytest.mark.parametrize("case", sorted(TF_CASES))
def test_transfer_function_matches(case):
    pos, cols = TF_CASES[case]
    jtf = jtypes.TransferFunction.from_points(pos, cols)
    ttf = ttypes.TransferFunction.from_points(pos, cols, device="cpu")
    close(ttf.positions, jtf.positions, 0, 0)
    close(ttf.lut, jtf.lut)
    x = np.random.default_rng(1).uniform(-0.2, 1.2, (64, 33)).astype(
        np.float32)
    close(ttf.sample(t(x)), jtf.sample(jnp.asarray(x)))
    close(ttf.sample_opacity(t(x)), jtf.sample_opacity(jnp.asarray(x)))


def test_encode_direction_and_irradiance_scale():
    d = np.random.default_rng(2).normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(ttypes.encode_direction(t(d)), jtypes.encode_direction(jnp.asarray(d)))
    for n, r in ((1024, 0.0153866), (65536, 0.0153866), (48, 0.09)):
        want = float(jtypes.relative_irradiance_scale(n, jnp.float32(r)))
        assert ttypes.relative_irradiance_scale(n, r) == pytest.approx(
            want, rel=RTOL)


def test_decode_direction_matches_and_inverts():
    # Away from the poles, where acos loses digits on the way back.
    ang = np.random.default_rng(3).uniform(
        (0.2, -3.0), (np.pi - 0.2, 3.0), (500, 2)).astype(np.float32)
    got = ttypes.decode_direction(t(ang))
    close(got, jtypes.decode_direction(jnp.asarray(ang)))
    np.testing.assert_allclose(ttypes.encode_direction(got).numpy(), ang,
                               rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("alpha", [0.3, 0.95])
def test_progressive_sphere_radius_matches(alpha):
    r = float(np.float32(0.0153866))
    for it in (1, 2, 7, 100):
        want = float(jtypes.progressive_sphere_radius(
            jnp.float32(r), jnp.int32(it), alpha))
        got = ttypes.progressive_sphere_radius(r, it, alpha)
        assert got == pytest.approx(want, rel=RTOL)
        assert got == float(np.float32(got)) and got < r
        r = got


def test_dirty_flags_match():
    from cpm_tpu.pipeline import state as jstate
    from cpm_tpu_torch.pipeline import state as tstate
    assert ([f.name for f in dataclasses.fields(tstate.DirtyFlags)]
            == [f.name for f in dataclasses.fields(jstate.DirtyFlags)])
    assert (dataclasses.asdict(tstate.ALL_DIRTY)
            == dataclasses.asdict(jstate.ALL_DIRTY))
    for kw in ({}, dict(progressive=True), dict(tf=True, progressive=True),
               dict(light=True), dict(volume=True), dict(camera=True)):
        a, b = tstate.DirtyFlags(**kw), jstate.DirtyFlags(**kw)
        assert (a.resets_iteration, a.any) == (b.resets_iteration, b.any)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tstate.DirtyFlags().tf = True


def test_photon_data_create_sentinels():
    ph = ttypes.PhotonData.create(10, 3, radius_rel=0.02,
                                   device="cpu")
    assert ph.positions.shape == (3, 10, 3) and ph.n == 10
    assert bool((ph.positions > 1e30).all()) and bool((ph.exit_power > 1e30).all())
    assert ph.radius_rel == float(np.float32(0.02))


def test_volume_scene_radius():
    data = np.zeros((4, 4, 4), np.float32)
    basis = np.diag([2.0, 1.0, 3.0]).astype(np.float32)
    want = float(jtypes.Volume.from_data(data, basis).scene_radius())
    assert ttypes.Volume.from_data(
        data, basis, device="cpu").scene_radius() == \
        pytest.approx(want, rel=RTOL)


# --- camera -----------------------------------------------------------------

@pytest.mark.parametrize("eye", [(0.5, 0.5, -1.5), (0.45, 0.6, -1.5),
                                 (2.0, 0.4, 0.5), (0.3, 2.2, 0.6)])
def test_camera_rays_match(eye):
    jo, jd = jcamera.Camera.create(eye=eye).rays(24, 16)
    to, td = tcamera.Camera.create(eye=eye, device="cpu").rays(24, 16)
    close(to, jo)
    close(td, jd)


# --- intersect --------------------------------------------------------------

def test_ray_box_matches():
    rs = np.random.default_rng(3)
    o = rs.uniform(-1.0, 2.0, (400, 3)).astype(np.float32)
    d = rs.normal(size=(400, 3)).astype(np.float32)
    d[:40, 0] = 0.0  # axis-parallel rays
    d[40:60, :2] = 0.0
    for lo, hi in ((0.0, 1.0), ((0.1, 0.2, 0.0), (0.9, 0.7, 1.0))):
        jh, jn, jf = jintersect.ray_box(jnp.asarray(o), jnp.asarray(d), lo, hi)
        th, tn, tf = tintersect.ray_box(t(o), t(d), lo, hi)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        close(tn, jn)
        close(tf, jf)
    close(tintersect.light_sample_box_intersection(t(o), t(d)),
          jintersect.light_sample_box_intersection(jnp.asarray(o),
                                                   jnp.asarray(d)))


# --- sampling ---------------------------------------------------------------

def test_stratified_grid_matches():
    np.testing.assert_array_equal(
        tsampling.stratified_grid_2d(7, 5, device="cpu").numpy(),
        np.asarray(jsampling.stratified_grid_2d(7, 5)))


@pytest.mark.parametrize("shape", [(16, 16, 16), (5, 9, 7)])
def test_trilinear_matches(shape):
    rs = np.random.default_rng(4)
    data = rs.random(shape).astype(np.float32)
    pos = rs.uniform(-0.1, 1.1, (1000, 3)).astype(np.float32)
    close(tsampling.sample_volume_trilinear(t(data), t(pos)),
          jsampling.sample_volume_trilinear(jnp.asarray(data),
                                            jnp.asarray(pos)))


# --- emit -------------------------------------------------------------------

@pytest.mark.parametrize("direction", [(0.0, -1.0, 0.3), (0.0, 0.0, 1.0),
                                       (0.8, -0.4, -0.2), (1.0, 1.0, 1.0),
                                       (-0.3, 0.2, -1.0), (0.0, -1.0, 0.0)])
def test_emit_directional_matches(direction):
    light = jlights.Light.directional(direction, (1.0, 0.8, 0.5))
    want = jemit.emit(light, jsampling.stratified_grid_2d(16, 12))
    got = temit.emit(light, tsampling.stratified_grid_2d(
        16, 12, device="cpu"))
    for f in ("origins", "directions", "powers", "tspan"):
        close(getattr(got, f), getattr(want, f))
    assert got.iteration == int(want.iteration)


# --- phase ------------------------------------------------------------------

@pytest.mark.parametrize("ptype,g", [(jphase.ISOTROPIC, 0.0),
                                     (jphase.HENYEY_GREENSTEIN, 0.6),
                                     (jphase.HENYEY_GREENSTEIN, -0.3),
                                     (jphase.HENYEY_GREENSTEIN, 0.0),
                                     (jphase.SCHLICK, 0.5)])
def test_sample_phase_matches(ptype, g):
    rs = np.random.default_rng(5)
    wi = rs.normal(size=(800, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    u1, u2 = rs.random((2, 800)).astype(np.float32)
    jwo, jpdf = jphase.sample_phase(ptype, jnp.asarray(wi), jnp.float32(g),
                                    jnp.asarray(u1), jnp.asarray(u2))
    two, tpdf = tphase.sample_phase(ptype, t(wi), g, t(u1), t(u2))
    # Directions are built from cos/sin of 2*pi*u: a few ulps of 2*pi.
    close(two, jwo, atol=1e-5)
    close(tpdf, jpdf)


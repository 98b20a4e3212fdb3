"""The port's emission modes against the JAX reference and against the
reference's own properties (CPU, small inputs from numpy seeds):

- the twins of ``jax.random.uniform`` and ``jax.random.split``, and the
  jittered sample grid, word for word;
- ``hilbert_index_2d`` and the Hilbert order of ``emit_all`` bit for bit;
- point, cone and area lights, and several lights in one ``init_state``;
- the guided-emission warp, both guides, a guided ``init_state`` and
  ``progressive_step_guided``;
- the properties of tests/test_guided_emission.py: the warp's histogram
  matches its density, a uniform guide is the identity, and guided
  emission is unbiased with less variance where it steers photons.
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
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                       TracerConfig)
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import emit as temit
from cpm_tpu_torch.ops import rng as trng
from cpm_tpu_torch.ops import sampling as tsampling
from cpm_tpu_torch.pipeline import step as tstep

# Emission math in float32 in two frameworks (cos/sin, z**5, norms).
EMIT_RTOL, EMIT_ATOL = 1e-5, 1e-6
# The warp: cumulative sums round differently in the last bits, by up to
# one float32 ulp per bin summed, and the inverse CDF divides that by the
# bin's mass; a sample's tolerance adds (Bu + Bv) ulps over its bin mass.
WARP_RTOL, WARP_ATOL = 1e-5, 1e-6
EPS32 = float(np.finfo(np.float32).eps)
# A sample within this distance of a CDF edge may land in the next bin in
# one package; at most this share of the samples may be that close.
EDGE, EDGE_SHARE = 1e-6, 1e-3
GUIDE_RTOL = 1e-5
# A whole wave from the same state: relative L1 of the light volume; the
# next guide, built from that wave's deposits.
STEP_REL_L1 = 1e-2
NEXT_GUIDE_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's small eager ops run fastest on one thread here: beside
    JAX's own thread pool, torch's pool costs ~8x on these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_of(tree) -> dict:
    """A reference pytree as {field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).sum() / np.abs(want).sum())


def _t(a):
    return torch.from_numpy(np.array(a))


def _key(seed, data):
    """The same key in both packages: (jax key, (k0, k1))."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    return jkey, trng.fold_in(trng.prng_key(seed), data)


def close(got, want, rtol=EMIT_RTOL, atol=EMIT_ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _blob(dim=32):
    """A dense blob in one octant (tests/test_guided_emission.py:72-82)."""
    z, y, x = np.mgrid[0:dim, 0:dim, 0:dim].astype(np.float32) / dim
    r = np.sqrt((x - 0.75) ** 2 + (y - 0.75) ** 2 + (z - 0.5) ** 2)
    return np.clip(1.0 - r / 0.2, 0.0, 1.0).astype(np.float32)


def _jscene(lights, data=None):
    return jscene.Scene.create(
        jtypes.Volume.from_data(_blob() if data is None else data),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        lights, jcamera.Camera.create())


def _port(scene):
    return convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                    device="cpu")


def _configs(photons=(32, 32), **kw):
    tracer = dict(max_interactions=2, max_steps=2500)
    jcfg = JPipelineConfig(tracer=JTracerConfig(**tracer),
                           render=JRenderConfig(width=8, height=8),
                           photons_x=photons[0], photons_y=photons[1], **kw)
    tcfg = PipelineConfig(tracer=TracerConfig(**tracer),
                          render=RenderConfig(width=8, height=8),
                          photons_x=photons[0], photons_y=photons[1], **kw)
    return jcfg, tcfg


def _same_samples(got, want, rtol=EMIT_RTOL, atol=EMIT_ATOL):
    for f in ("origins", "directions", "powers", "tspan"):
        close(getattr(got, f), getattr(want, f), rtol, atol, f)
    assert got.iteration == int(want.iteration)


# --- the RNG twins ------------------------------------------------------------


@pytest.mark.parametrize("seed,data,shape", [
    (0, 2, (5, 3)), (0, 1, (1000, 3)), (7, 0, (7,)), (123, 9, (3, 4, 5)),
    (-5, 2 ** 31 - 1, (1,))])
def test_uniform_twin_word_for_word(seed, data, shape):
    jkey, tkey = _key(seed, data)
    want = np.asarray(jax.random.uniform(jkey, shape))
    got = trng.uniform(tkey, shape, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_twin_word_for_word(num):
    jkey, tkey = _key(11, 3)
    want = [tuple(int(w) for w in k) for k in np.asarray(
        jax.random.split(jkey, num))]
    assert trng.split(tkey, num) == want


@pytest.mark.parametrize("nx,ny", [(7, 5), (16, 16)])
def test_jittered_grid_bit_exact(nx, ny):
    jkey, tkey = _key(4, 1)
    want = np.asarray(jsampling.stratified_grid_2d(nx, ny, key=jkey))
    got = tsampling.stratified_grid_2d(nx, ny, key=tkey, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# --- Hilbert order -------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 3, 6, 9])
def test_hilbert_index_bit_exact(order):
    rs = np.random.default_rng(order)
    u = rs.uniform(-0.1, 1.1, 4000).astype(np.float32)
    v = rs.uniform(-0.1, 1.1, 4000).astype(np.float32)
    u[:4] = v[-4:] = (0.0, 1.0, np.nextafter(np.float32(1), 0), 0.5)
    want = np.asarray(jsampling.hilbert_index_2d(jnp.asarray(u),
                                                 jnp.asarray(v), order))
    got = tsampling.hilbert_index_2d(_t(u), _t(v), order)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > min(4 ** order, 4000) // 2


def test_emit_all_hilbert_order_bit_exact():
    """The same permutation of the sample grid, and the same bundle."""
    photons = (32, 24)
    scene = _jscene([jlights.Light.directional((0.2, -1.0, 0.3))])
    jcfg, tcfg = _configs(photons, sample_order="hilbert")
    jkey, tkey = _key(0, 1)
    grid = np.asarray(jsampling.stratified_grid_2d(*photons))
    order = max(photons).bit_length()
    want_perm = np.asarray(jnp.argsort(jsampling.hilbert_index_2d(
        jnp.asarray(grid[:, 0]), jnp.asarray(grid[:, 1]), order=order)))
    got_perm = torch.argsort(tsampling.hilbert_index_2d(
        _t(grid[:, 0]), _t(grid[:, 1]), order=order), stable=True)
    np.testing.assert_array_equal(got_perm.numpy(), want_perm)
    assert not (want_perm == np.arange(len(grid))).all()
    _same_samples(tstep.emit_all(_port(scene), tcfg, tkey),
                  jstep.emit_all(scene, jcfg, jkey))


# --- point, cone and area lights -------------------------------------------


LIGHTS = {
    "point": jlights.Light.point((0.5, 1.3, 0.4), (1.0, 0.8, 0.5)),
    "point_inside": jlights.Light.point((0.5, 0.5, 0.5)),
    "cone": jlights.Light.cone((0.5, 1.5, 0.5), (0.1, -1.0, 0.2),
                               radiance=(0.7, 0.9, 1.0)),
    "cone_wide": jlights.Light.cone((-0.4, 0.3, 0.6), (1.0, 0.2, -0.1),
                                    cos_fov=0.2),
    "area": jlights.Light.area((0.5, 1.5, 0.5), (0.0, -1.0, 0.0),
                               (0.6, 0.4), (1.0, 0.8, 0.5)),
    "area_tilted": jlights.Light.area((1.4, 0.6, -0.3), (-1.0, 0.1, 0.8)),
}


@pytest.mark.parametrize("name", sorted(LIGHTS))
def test_emit_light_matches(name):
    light = LIGHTS[name]
    jkey, tkey = _key(3, 2)
    grid = np.asarray(jsampling.stratified_grid_2d(24, 20, key=jkey))
    kw = dict(iteration=3)
    if name == "area":
        akey, tkey_a = _key(9, 1)
        want = jemit.emit(light, jnp.asarray(grid), key=akey, **kw)
        got = temit.emit(light, _t(grid), key=tkey_a, **kw)
        # The targets are the reference's draws, bit for bit.
        np.testing.assert_array_equal(
            trng.uniform(tkey_a, (len(grid), 3), device="cpu").numpy(),
            np.asarray(jax.random.uniform(akey, (len(grid), 3))))
    else:
        # No key: an area light draws under PRNGKey(0) in both.
        want = jemit.emit(light, jnp.asarray(grid), **kw)
        got = temit.emit(light, _t(grid), **kw)
    _same_samples(got, want)
    hits = np.asarray(want.tspan)[:, 1] >= np.asarray(want.tspan)[:, 0]
    assert hits.any()
    norms = np.linalg.norm(got.directions.numpy(), axis=-1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_init_state_with_several_lights_matches():
    """Four lights in one bundle; light i draws under fold_in(key, i), so
    the area light's targets follow its place in the list."""
    lights = [jlights.Light.directional((0.0, -1.0, 0.3)),
              LIGHTS["area"], LIGHTS["point"], LIGHTS["cone"],
              LIGHTS["area_tilted"]]
    scene = _jscene(lights)
    jcfg, tcfg = _configs((12, 10))
    want = jstep.init_state(scene, jcfg, seed=5)
    got = tstep.init_state(_port(scene), tcfg, seed=5)
    assert got.light_samples.n == 5 * 120
    _same_samples(got.light_samples, want.light_samples)
    assert got.key == tuple(int(w) for w in np.asarray(want.key))


# --- the guided-emission warp ------------------------------------------------


def _cdfs64(guide, floor):
    """The warp's CDFs in float64 numpy, to find samples near an edge."""
    g = np.maximum(np.asarray(guide, np.float64), 0.0)
    f = (1.0 - floor) * g / max(g.mean(), 1e-20) + floor
    mv = f.mean(1) / f.mean(1).sum()
    cdf_v = np.concatenate([[0.0], np.cumsum(mv)])
    cdf_u = np.concatenate([np.zeros((len(f), 1)),
                            np.cumsum(f / f.sum(1, keepdims=True), 1)], 1)
    return cdf_v, cdf_u


def _edges_and_masses(samples, guide, floor):
    """(near an edge, the bin masses of v and u) for every sample."""
    cdf_v, cdf_u = _cdfs64(guide, floor)
    u, v = samples[:, 0].astype(np.float64), samples[:, 1].astype(np.float64)
    r = np.clip(np.searchsorted(cdf_v, v, side="right") - 1, 0,
                len(cdf_v) - 2)
    rows = cdf_u[r]
    c = np.clip((rows <= u[:, None]).sum(1) - 1, 0, rows.shape[1] - 2)
    near = ((np.abs(v[:, None] - cdf_v[None]).min(1) < EDGE)
            | (np.abs(u[:, None] - rows).min(1) < EDGE))
    mass_u = np.take_along_axis(rows, c[:, None] + 1, 1)[:, 0] - \
        np.take_along_axis(rows, c[:, None], 1)[:, 0]
    return near, cdf_v[r + 1] - cdf_v[r], mass_u


GUIDES = {
    "skewed_8x8": lambda rs: rs.random((8, 8), dtype=np.float32) ** 3,
    "zeros_6x10": lambda rs: np.where(rs.random((6, 10)) < 0.5, 0.0,
                                      rs.random((6, 10))).astype(np.float32),
    "one_hot_16x16": lambda rs: np.eye(16, dtype=np.float32)[3:4].repeat(
        16, 0) * np.eye(16, dtype=np.float32)[:, 5:6],
    "negative_4x4": lambda rs: rs.normal(size=(4, 4)).astype(np.float32),
}


@pytest.mark.parametrize("floor", [0.1, 0.25])
@pytest.mark.parametrize("name", sorted(GUIDES))
def test_warp_matches_reference(name, floor):
    """u', v' and pdf allclose (to WARP tolerances plus (Bu + Bv) ulps over
    the sample's bin mass); the selected bins equal, except for samples
    within EDGE of a CDF edge, which may land in the neighbouring bin and
    are at most EDGE_SHARE of all."""
    rs = np.random.default_rng(len(name))
    guide = GUIDES[name](rs)
    n = 1 << 14
    s = np.stack([rs.random(n, dtype=np.float32),
                  rs.random(n, dtype=np.float32),
                  rs.random(n, dtype=np.float32),
                  rs.uniform(0.5, 2.0, n).astype(np.float32)], -1)
    want = np.asarray(jsampling.warp_samples_2d(jnp.asarray(s),
                                                jnp.asarray(guide),
                                                floor=floor))
    got = tsampling.warp_samples_2d(_t(s), _t(guide), floor=floor).numpy()
    near, mass_v, mass_u = _edges_and_masses(s, guide, floor)
    assert near.mean() <= EDGE_SHARE, near.sum()
    ok = ~near
    bv, bu = guide.shape
    for col, bins in ((0, bu), (1, bv)):
        np.testing.assert_array_equal(np.floor(got[ok, col] * bins),
                                      np.floor(want[ok, col] * bins))
    ulps = (bu + bv) * EPS32
    for col, tol in ((0, WARP_ATOL + ulps / (mass_u * bu)),
                     (1, WARP_ATOL + ulps / (mass_v * bv)),
                     (3, (WARP_RTOL + ulps / mass_u + ulps / mass_v)
                      * np.abs(want[:, 3]))):
        err = np.abs(got[:, col] - want[:, col])
        assert (err[ok] <= tol[ok]).all(), (col, (err / tol)[ok].max())
    np.testing.assert_array_equal(got[:, 2], s[:, 2])
    print(f"{name}, floor {floor}: {int(near.sum())} of {n} samples within "
          f"{EDGE} of a CDF edge")


def test_warp_histogram_matches_density_and_pdf_is_exact():
    """tests/test_guided_emission.py:31-63 on the port."""
    bv, bu = 8, 8
    key = trng.prng_key(0)
    guide = trng.uniform(key, (bv, bu), device="cpu") ** 3
    n = 1 << 16
    u = trng.uniform(trng.fold_in(key, 1), (n,), device="cpu")
    v = trng.uniform(trng.fold_in(key, 2), (n,), device="cpu")
    s = torch.stack([u, v, torch.zeros(n), torch.ones(n)], dim=-1)
    w = tsampling.warp_samples_2d(s, guide, floor=0.2).numpy()
    assert w[:, 0].min() >= 0 and w[:, 0].max() <= 1
    assert w[:, 1].min() >= 0 and w[:, 1].max() <= 1
    g = np.maximum(guide.numpy(), 0)
    f = 0.8 * g / g.mean() + 0.2
    hist, _, _ = np.histogram2d(w[:, 1], w[:, 0], bins=[bv, bu],
                                range=[[0, 1], [0, 1]])
    np.testing.assert_allclose(hist / n, f / f.sum(), atol=4.0 / np.sqrt(n))
    iv = np.clip((w[:, 1] * bv).astype(int), 0, bv - 1)
    iu = np.clip((w[:, 0] * bu).astype(int), 0, bu - 1)
    np.testing.assert_allclose(w[:, 3], f[iv, iu], rtol=1e-4)
    est = np.mean((np.sin(3 * w[:, 0]) * w[:, 1] ** 2 + 0.3) / w[:, 3])
    assert abs(est - (((1 - np.cos(3.0)) / 3.0) / 3.0 + 0.3)) < 0.01


def test_uniform_guide_is_identity():
    s = tsampling.stratified_grid_2d(16, 16, device="cpu")
    w = tsampling.warp_samples_2d(s, torch.ones(4, 4), floor=0.5)
    torch.testing.assert_close(w, s, rtol=0.0, atol=1e-6)


# --- the two guides ------------------------------------------------------------


@pytest.fixture(scope="module")
def importance():
    """The reference's importance grid of the blob scene, as numpy."""
    scene = _jscene([jlights.Light.directional((0.0, -1.0, 0.0))])
    grid = jstep.build_importance_grid(scene, _configs()[0])
    return {k: np.asarray(getattr(grid, k))
            for k in ("data", "cell_dim", "volume_dim")}


def _grids(imp):
    jgrid = jtypes.UniformGrid3D(**{k: jnp.asarray(v)
                                    for k, v in imp.items()})
    tgrid = ttypes.UniformGrid3D(**{k: _t(v) for k, v in imp.items()})
    return jgrid, tgrid


@pytest.mark.parametrize("direction", [(0.0, -1.0, 0.0), (0.2, -1.0, 0.3),
                                       (1.0, 1.0, 1.0)])
def test_build_emission_guide_matches(importance, direction):
    light = jlights.Light.directional(direction)
    jgrid, tgrid = _grids(importance)
    want = np.asarray(jemit.build_emission_guide(jgrid, light, 16, 12, 32))
    got = temit.build_emission_guide(tgrid, light, 16, 12, 32).numpy()
    assert got.shape == want.shape == (12, 16)
    close(got, want, GUIDE_RTOL, GUIDE_RTOL * want.max())
    assert want.max() > 0
    with pytest.raises(ValueError):
        temit.build_emission_guide(tgrid, LIGHTS["point"])


def test_emission_guide_from_wave_matches():
    rs = np.random.default_rng(8)
    n = 3000
    uv = rs.uniform(-0.05, 1.05, (n, 2)).astype(np.float32)
    pdf = rs.uniform(0.2, 3.0, n).astype(np.float32)
    dep = rs.normal(size=(3, n, 3)).astype(np.float32)
    dep[:, rs.random(n) < 0.3] = 0.0
    dep[1, 7] = np.inf  # a non-finite lane counts as no contribution
    want = np.asarray(jemit.emission_guide_from_wave(
        jnp.asarray(uv), jnp.asarray(pdf), jnp.asarray(dep), n_u=10, n_v=6))
    got = temit.emission_guide_from_wave(_t(uv), _t(pdf), _t(dep), n_u=10,
                                         n_v=6).numpy()
    assert got.shape == (6, 10)
    close(got, want, GUIDE_RTOL, 1e-6)


def _lanes_close(got, want):
    """The share of lanes whose origin, power and pdf-carrying fields agree
    to EMIT tolerances (a warped lane near a CDF edge may take the next
    bin)."""
    ok = np.ones(got.n, bool)
    for f in ("origins", "directions", "powers", "tspan"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        ok &= np.all(np.abs(a - b) <= EMIT_ATOL + EMIT_RTOL * np.abs(b), -1)
    return ok.mean()


def test_init_state_guided_matches(importance):
    scene = _jscene([jlights.Light.directional((0.0, -1.0, 0.0)),
                     LIGHTS["point"]])
    jcfg, tcfg = _configs((24, 24), guided_emission=True,
                          guide_resolution=16, guide_floor=0.15)
    jgrid, tgrid = _grids(importance)
    want = jstep.init_state(scene, jcfg, importance_grid=jgrid)
    got = tstep.init_state(_port(scene), tcfg, importance_grid=tgrid)
    plain = tstep.init_state(_port(scene), dataclasses.replace(
        tcfg, guided_emission=False))
    assert _lanes_close(got.light_samples, want.light_samples) >= 1 - EDGE_SHARE
    # The warp moved the directional light's samples, not the point
    # light's.
    moved = torch.any(got.light_samples.origins
                      != plain.light_samples.origins, dim=-1)
    assert bool(moved[:576].any()) and not bool(moved[576:].any())


def test_progressive_step_guided_matches(importance):
    """Two guided ticks from the reference's traced state: the pilot wave
    (no guide) and a wave warped by the pilot's guide. Light volumes within
    1% relative L1, the next guide at rtol 1e-4 of its peak."""
    scene = _jscene([jlights.Light.directional((0.0, -1.0, 0.0))])
    jcfg, tcfg = _configs((32, 32), guide_resolution=16)
    state = jstep.full_trace_step(scene, jstep.init_state(scene, jcfg), jcfg)
    tscene = _port(scene)
    tstate = convert.state_from_numpy(leaves_of(state), device="cpu")
    jguide = tguide = None
    for tick in (1, 2):
        # Both packages warp by the reference's guide of the last wave.
        given = None if jguide is None else _t(np.asarray(jguide))
        state, jguide = jstep.progressive_step_guided(scene, state, jcfg,
                                                      guide=jguide)
        tstate, tguide = tstep.progressive_step_guided(tscene, tstate, tcfg,
                                                       guide=given)
        assert tstate.photons.iteration == int(state.photons.iteration) == tick
        assert tstate.light_samples.iteration == tick
        err = rel_l1(tstate.light_volume.numpy(), state.light_volume)
        g, want_g = tguide.numpy(), np.asarray(jguide)
        print(f"tick {tick}: light volume rel L1 {err:.3e}, next guide max "
              f"err {np.abs(g - want_g).max():.3e} of {want_g.max():.3e}")
        assert err < STEP_REL_L1
        assert rel_l1(tstate.light_volume_accum.numpy(),
                      state.light_volume_accum) < STEP_REL_L1
        close(g, want_g, NEXT_GUIDE_RTOL, NEXT_GUIDE_RTOL * want_g.max())
    with pytest.raises(ValueError):
        tstep.progressive_step_guided(
            dataclasses.replace(tscene, lights=(LIGHTS["point"],)), tstate,
            tcfg)


def test_guided_emission_unbiased_and_variance_reduced(importance):
    """tests/test_guided_emission.py:93-125 on the port: six uniform and six
    guided waves at 48^2 photons; the total irradiance agrees within 15%,
    and the blob's summed irradiance varies less from wave to wave."""
    scene = _port(_jscene([jlights.Light.directional((0.0, -1.0, 0.0))]))
    _, base = _configs((48, 48))
    guided = dataclasses.replace(base, guided_emission=True,
                                 guide_resolution=16, guide_floor=0.15)
    grid = tstep.build_importance_grid(scene, base)
    assert float(grid.data.max()) > 0

    def wave(cfg, seed, ig):
        st = tstep.init_state(scene, cfg, seed=seed, importance_grid=ig)
        return tstep.full_trace_step(scene, st, cfg).light_volume.numpy()

    waves_u = [wave(base, s, None) for s in range(6)]
    waves_g = [wave(guided, s, grid) for s in range(6)]
    tot_u = np.mean(waves_u, axis=0).sum()
    tot_g = np.mean(waves_g, axis=0).sum()
    assert abs(tot_g - tot_u) / max(tot_u, 1e-9) < 0.15
    d = waves_u[0].shape[0]
    blob = (slice(d // 4, 3 * d // 4), slice(d // 2, d), slice(d // 2, d))
    s_u = [w[blob].sum() for w in waves_u]
    s_g = [w[blob].sum() for w in waves_g]
    var_u = np.var(s_u) / max(np.mean(s_u), 1e-9) ** 2
    var_g = np.var(s_g) / max(np.mean(s_g), 1e-9) ** 2
    print(f"bias {abs(tot_g - tot_u) / tot_u:.3e}, blob rel variance "
          f"uniform {var_u:.3e}, guided {var_g:.3e}")
    assert var_g < var_u, (var_g, var_u)

"""The port's path-importance integrals (DDA, gather quadrature, segment
assembly over stored photon paths, equal importance, the grid dilation)
against the JAX reference and the float64 DDA oracle on the same numpy
inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import lights as jlights
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import (PipelineConfig as JPipelineConfig,
                                 RecomputeConfig as JRecomputeConfig,
                                 TracerConfig as JTracerConfig)
from cpm_tpu.io import synthetic
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import path_importance as jpi
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu.oracle.reference import dda_integral_oracle
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       TracerConfig)
from cpm_tpu_torch.ops import path_importance as tpi
from cpm_tpu_torch.pipeline import step as tstep

# Same float32 operations in two frameworks; XLA may fuse the DDA's
# multiply-adds, so sums of ~10 terms differ in the last bits.
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5
# Against the float64 oracle: a float32 traversal can step a boundary in
# another order than float64 where two crossings nearly tie, which moves
# that segment's integral; 99% of segments must agree to 1e-4.
ORACLE_RTOL, ORACLE_ATOL, ORACLE_MIN_SHARE = 1e-4, 1e-4, 0.99


def _t(a):
    return torch.from_numpy(np.array(a))


def _segments(seed, m, extent):
    rs = np.random.default_rng(seed)
    x1 = rs.uniform(0.5, extent - 0.5, (m, 3)).astype(np.float32)
    x2 = rs.uniform(0.5, extent - 0.5, (m, 3)).astype(np.float32)
    # Degenerate and axis-parallel segments, and the collapsed segment
    # photon_path_importance makes of an unused slot.
    x2[0] = x1[0]
    x2[1, :2] = x1[1, :2]
    x1[2] = x2[2] = 0.0
    x2[3, 0] = x1[3, 0]
    return x1, x2


@pytest.mark.parametrize("shape,cell,steps", [((4, 4, 4), 4.0, 32),
                                              ((3, 5, 6), 8.0, 40)])
def test_dda_matches_reference_and_oracle(shape, cell, steps):
    rs = np.random.default_rng(7)
    grid = rs.random(shape).astype(np.float32)
    cell_dim = np.full(3, cell, np.float32)
    extent = cell * min(shape)
    x1, x2 = _segments(8, 400, extent)
    got = tpi.grid_segment_integral(_t(grid), _t(x1), _t(x2), _t(cell_dim),
                                    max_steps=steps).numpy()
    assert np.all(np.isfinite(got))
    assert got[0] == 0.0 and got[2] == 0.0
    want = np.asarray(jpi.grid_segment_integral(
        jnp.asarray(grid), jnp.asarray(x1), jnp.asarray(x2),
        jnp.asarray(cell_dim), max_steps=steps))
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=JAX_ATOL)
    oracle = np.array([
        dda_integral_oracle(grid, x1[i].astype(np.float64),
                            x2[i].astype(np.float64),
                            cell_dim.astype(np.float64))
        for i in range(4, len(x1))])
    ok = np.isclose(got[4:], oracle, rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
    print(f"DDA vs float64 oracle: {ok.mean():.4f} of {ok.size} segments "
          f"within rtol {ORACLE_RTOL}")
    assert ok.mean() >= ORACLE_MIN_SHARE


def test_dda_of_a_constant_grid_is_the_length():
    grid = torch.ones((4, 4, 4))
    out = tpi.grid_segment_integral(
        grid, torch.tensor([[1.0, 1.0, 1.0]]),
        torch.tensor([[13.0, 9.0, 5.0]]), torch.tensor([4.0, 4.0, 4.0]),
        max_steps=16)
    assert float(out[0]) == pytest.approx(np.linalg.norm([12.0, 8.0, 4.0]),
                                          rel=1e-4)


@pytest.mark.parametrize("n_samples", [4, 8])
def test_quadrature_matches_reference(n_samples):
    rs = np.random.default_rng(0)
    grid = rs.random((7, 5, 6)).astype(np.float32)
    x1, x2 = _segments(1, 503, 40.0)
    cell = np.full(3, 8.0, np.float32)
    got = tpi.grid_segment_integral_quadrature(
        _t(grid), _t(x1), _t(x2), _t(cell), n_samples).numpy()
    args = (jnp.asarray(grid), jnp.asarray(x1), jnp.asarray(x2),
            jnp.asarray(cell), n_samples)
    np.testing.assert_allclose(
        got, np.asarray(jpi.grid_segment_integral_quadrature(*args)),
        rtol=JAX_RTOL, atol=JAX_ATOL)
    # The one-hot matrix-product form has the gather quadrature's values.
    np.testing.assert_allclose(
        got, np.asarray(jpi.grid_segment_integral_quadrature_mxu(*args)),
        rtol=JAX_RTOL, atol=JAX_ATOL)


def test_equal_importance_is_exact():
    for n, it, pct in ((100, 0, 10), (100, 1, 10), (257, 5, 25), (64, 3, 100),
                       (50, 2, 7)):
        got = tpi.equal_importance(n, it, pct, device="cpu")
        want = jpi.equal_importance(n, jnp.int32(it), pct)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = tpi.equal_importance(100, 0, 10, device="cpu")
    b = tpi.equal_importance(100, 1, 10, device="cpu")
    assert float(a.sum()) == float(b.sum()) == 10.0
    assert not torch.equal(a, b)


# --- photon_path_importance from a shared traced state -----------------------


@pytest.fixture(scope="module")
def traced():
    """A JAX trace of 32^2 photons x 3 interactions through a 32^3 sphere,
    carried to the port as numpy arrays, and a seeded importance grid."""
    vol = jtypes.Volume.from_data(synthetic.sphere_in_box(32))
    tf = jtypes.TransferFunction.from_points(*synthetic.default_tf_points())
    tfs = jtypes.TransferFunction.from_points(
        *synthetic.default_scattering_points())
    jls = jemit.emit(jlights.Light.directional((0.0, -1.0, 0.3)),
                     jsampling.stratified_grid_2d(32, 32))
    jph = jtracer.trace_photons(vol, tf, tfs, jls, jax.random.PRNGKey(5),
                                JTracerConfig(max_interactions=3,
                                              max_steps=3000))
    tls = ttypes.LightSamples(
        **{f: _t(getattr(jls, f))
           for f in ("origins", "directions", "powers", "tspan")})
    tph = ttypes.PhotonData(
        **{f: _t(getattr(jph, f))
           for f in ("positions", "powers", "directions", "exit_power",
                     "exit_direction")},
        radius_rel=float(jph.radius_rel),
        scene_radius=float(jph.scene_radius))
    data = np.random.default_rng(2).random((4, 4, 4)).astype(np.float32)
    data[data < 0.4] = 0.0
    cell = np.full(3, 8.0, np.float32)
    vdim = np.full(3, 32.0, np.float32)
    jgrid = jtypes.UniformGrid3D(data=jnp.asarray(data),
                                 cell_dim=jnp.asarray(cell),
                                 volume_dim=jnp.asarray(vdim))
    tgrid = ttypes.UniformGrid3D(data=_t(data), cell_dim=_t(cell),
                                 volume_dim=_t(vdim))
    return jph, jls, jgrid, tph, tls, tgrid


@pytest.mark.parametrize("mode", ["dda", "quadrature", "quadrature_mxu"])
def test_photon_path_importance_matches(traced, mode):
    jph, jls, jgrid, tph, tls, tgrid = traced
    used = np.asarray(jph.positions)[..., 0] < 1e30
    assert used[0].sum() > 100 and (~used[0]).sum() > 100
    absorbed = np.asarray(jph.exit_power) > 1e30
    assert absorbed.sum() > 10 and (~absorbed & used[0]).sum() > 10
    want = np.asarray(jpi.photon_path_importance(
        jgrid, jph, jls, max_steps=24, mode=mode, n_samples=8))
    got = tpi.photon_path_importance(tgrid, tph, tls, max_steps=24,
                                     mode=mode, n_samples=8).numpy()
    assert got.shape == (1024,) and np.all(np.isfinite(got))
    assert got.max() > 0.0
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_quadrature_mxu_is_the_gather_quadrature(traced):
    *_, tph, tls, tgrid = traced
    a = tpi.photon_path_importance(tgrid, tph, tls, mode="quadrature")
    b = tpi.photon_path_importance(tgrid, tph, tls, mode="quadrature_mxu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tpi.photon_path_importance(tgrid, tph, tls, mode="mxu")


def test_path_importance_semantics():
    """Straight rays through a hot octant rank above rays that miss it, and
    an absorbed path stops at its photon
    (tests/test_importance.py:140-180)."""
    n = 8
    g = np.zeros((2, 2, 2), np.float32)
    g[0, 0, 0] = 1.0
    grid = ttypes.UniformGrid3D(data=_t(g), cell_dim=torch.full((3,), 8.0),
                                volume_dim=torch.full((3,), 16.0))
    origins = np.tile(np.array([[0.25, 0.25, 0.0]], np.float32), (n, 1))
    origins[n // 2:] = [0.75, 0.75, 0.0]
    ls = ttypes.LightSamples(
        origins=_t(origins),
        directions=_t(np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))),
        powers=torch.ones((n, 3)),
        tspan=_t(np.tile(np.array([[0, 1]], np.float32), (n, 1))))
    straight = ttypes.PhotonData.create(n, 2, device="cpu")
    full = tpi.photon_path_importance(grid, straight, ls).numpy()
    assert np.all(full[:n // 2] > 0.0)
    np.testing.assert_allclose(full[n // 2:], 0.0, atol=1e-6)
    straight.positions[0, 0] = torch.tensor([0.25, 0.25, 0.25])
    stopped = tpi.photon_path_importance(grid, straight, ls).numpy()
    assert 0 < stopped[0] < full[0]
    # A light sample that misses the volume (tspan = (0, -1)) scores 0.
    ls.tspan[1] = torch.tensor([0.0, -1.0])
    assert float(tpi.photon_path_importance(grid, straight, ls)[1]) == 0.0


@pytest.mark.parametrize("ring,exact", [(0, False), (1, False), (1, True)])
def test_recompute_importance_dilation_is_exact(traced, ring, exact):
    """The (2r+1)^3 dilation against ``reduce_window``, and the importance
    that comes out against the reference's."""
    jph, jls, jgrid, tph, tls, tgrid = traced
    kw = dict(block_ring=ring, empty_jump_cap=1)
    rc = dict(exact_coverage=exact, importance_mode="quadrature")
    jcfg = JPipelineConfig(tracer=JTracerConfig(**kw),
                           recompute=JRecomputeConfig(**rc))
    tcfg = PipelineConfig(tracer=TracerConfig(**kw),
                          recompute=RecomputeConfig(**rc))
    r = ring + (2 if exact else 0)
    data = np.asarray(jgrid.data)
    want = np.asarray(jax.lax.reduce_window(
        jgrid.data, -jnp.inf, jax.lax.max, (2 * r + 1,) * 3, (1, 1, 1),
        "SAME"))
    got = torch.nn.functional.max_pool3d(
        tgrid.data[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= data).all() and (r == 0 or (want > data).any())
    np.testing.assert_allclose(
        tstep.recompute_importance(tcfg, tgrid, tph, tls).numpy(),
        np.asarray(jstep.recompute_importance(jcfg, jgrid, jph, jls)),
        rtol=JAX_RTOL, atol=JAX_ATOL)

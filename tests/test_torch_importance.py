"""The port's importance grids (Lab metric, TF envelope, per-cell
classification, time-varying and incremental TF-difference modes, the
grid constructors of the pipeline) against the JAX reference on the same
numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import lights as jlights
from cpm_tpu.core import scene as jscene
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import PipelineConfig as JPipelineConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import importance as jimp
from cpm_tpu.ops import minmax as jminmax
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import lights as tlights
from cpm_tpu_torch.core import scene as tscene_mod
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import PipelineConfig
from cpm_tpu_torch.ops import importance as timp
from cpm_tpu_torch.pipeline import step as tstep

# float32 elementwise math in two frameworks; importances are O(0.1..1).
RTOL, ATOL = 1e-5, 1e-6
# Lab coordinates span 100 units and come from differences of cube roots,
# so an ulp of a root (6e-8) is 3e-5 of a or b: absolute, in Lab units.
LAB_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tf_points(seed, p=6):
    rs = np.random.default_rng(seed)
    pos = np.sort(rs.random(p)).astype(np.float32)
    pos[0], pos[-1] = 0.0, 1.0
    col = rs.random((p, 4)).astype(np.float32)
    col[:2, 3] = 0.0  # a transparent range at the low end
    return pos, col


def _minmax(seed, shape=(3, 4, 5)):
    rs = np.random.default_rng(seed)
    a, b = rs.random(shape + (1,)), rs.random(shape + (1,))
    return np.concatenate([np.minimum(a, b), np.maximum(a, b)],
                          -1).astype(np.float32)


def test_lab_normalization_and_weights():
    assert timp.LAB_NORMALIZATION == jimp.LAB_NORMALIZATION
    for kw in ({}, dict(color=2.0, opacity=0.5), dict(
            color=0.0, color_diff=0.0, opacity_diff=0.0, opacity=0.0)):
        assert (timp.ImportanceWeights(**kw).normalized()
                == jimp.ImportanceWeights(**kw).normalized())


def test_rgb2lab_matches():
    rs = np.random.default_rng(0)
    rgb = np.concatenate([
        rs.random((500, 3), dtype=np.float32),
        np.array([[0, 0, 0], [1, 1, 1], [0.04045, 0.04045, 0.04045],
                  [0.04, 0.5, 0.0], [1, 0, 0], [0, 0, 1]], np.float32)])
    got = timp.rgb2lab(_t(rgb)).numpy()
    _close(got, jimp.rgb2lab(jnp.asarray(rgb)), atol=LAB_ATOL)
    _close(timp.rgb2lab(_t(np.ones(3, np.float32))).numpy(),
           [100.0, 0.0, 0.0], rtol=0, atol=0.2)


@pytest.mark.parametrize("seed", [0, 1])
def test_tf_points_importance_matches(seed):
    rs = np.random.default_rng(seed)
    a = rs.random((64, 4), dtype=np.float32)
    b = rs.random((64, 4), dtype=np.float32)
    a[:8, 3] = 0.0
    b[:4, 3] = 0.0  # rows 0-3: both transparent -> exactly 0
    w = jimp.ImportanceWeights(color=1.0, color_diff=2.0, opacity_diff=0.5,
                               opacity=1.5).normalized()
    got = timp.tf_points_importance(_t(a), _t(b), w).numpy()
    _close(got, jimp.tf_points_importance(jnp.asarray(a), jnp.asarray(b), w))
    assert np.all(got[:4] == 0.0) and np.all(got[8:] > 0.0)
    _close(timp.tf_points_importance_incremental(_t(b)).numpy(),
           jimp.tf_points_importance_incremental(jnp.asarray(b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_envelope_matches(seed):
    pos, col = _tf_points(seed)
    mm = _minmax(seed + 10).reshape(-1, 2)
    # Ranges that end exactly on control points: "strictly inside" matters.
    mm[0], mm[1] = (pos[1], pos[3]), (pos[2], pos[2])
    want = jimp.color_envelope(jnp.asarray(pos), jnp.asarray(col),
                               jnp.asarray(mm[:, 0]), jnp.asarray(mm[:, 1]))
    got = timp.color_envelope(_t(pos), _t(col), _t(mm[:, 0]), _t(mm[:, 1]))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_classify_importance_matches(seed, incremental):
    pos, col = _tf_points(seed)
    mm = _minmax(seed + 20)
    w = None if incremental else jimp.ImportanceWeights().normalized()
    want = jimp.classify_importance(jnp.asarray(mm), jnp.asarray(pos),
                                    jnp.asarray(col), w,
                                    incremental=incremental)
    got = timp.classify_importance(_t(mm), _t(pos), _t(col), w,
                                   incremental=incremental)
    assert tuple(got.shape) == mm.shape[:-1]
    assert float(got.max()) > 0.0
    _close(got.numpy(), want)


def test_classify_time_varying_importance_matches():
    pos, col = _tf_points(3)
    mm, prev = _minmax(30), _minmax(31)
    diff = np.random.default_rng(4).random(mm.shape[:-1]).astype(np.float32)
    w = jimp.ImportanceWeights(opacity=3.0).normalized()
    want = jimp.classify_time_varying_importance(
        jnp.asarray(mm), jnp.asarray(prev), jnp.asarray(diff),
        jnp.asarray(pos), jnp.asarray(col), w)
    got = timp.classify_time_varying_importance(
        _t(mm), _t(prev), _t(diff), _t(pos), _t(col), w)
    _close(got.numpy(), want)
    # Scaled by the per-cell difference (tests/test_importance.py:89-97).
    half = timp.classify_time_varying_importance(
        _t(mm), _t(prev), _t(diff * 0.5), _t(pos), _t(col), w)
    _close(half.numpy(), got.numpy() * 0.5)


# --- the pipeline's grid constructors --------------------------------------


def _scenes(data, tf_points=None):
    tf_points = tf_points or synthetic.default_tf_points()
    scat = synthetic.default_scattering_points()
    js = jscene.Scene.create(
        jtypes.Volume.from_data(data),
        jtypes.TransferFunction.from_points(*tf_points),
        jtypes.TransferFunction.from_points(*scat),
        [jlights.Light.directional((0.0, -1.0, 0.3))])
    ts = tscene_mod.Scene.create(
        ttypes.Volume.from_data(data, device="cpu"),
        ttypes.TransferFunction.from_points(*tf_points, device="cpu"),
        ttypes.TransferFunction.from_points(*scat, device="cpu"),
        [tlights.Light.directional((0.0, -1.0, 0.3))])
    return js, ts


@pytest.fixture(scope="module")
def sphere():
    return _scenes(synthetic.sphere_in_box(32))


def _grid_close(got, want):
    _close(got.data.numpy(), want.data)
    np.testing.assert_array_equal(got.cell_dim.numpy(),
                                  np.asarray(want.cell_dim))
    np.testing.assert_array_equal(got.volume_dim.numpy(),
                                  np.asarray(want.volume_dim))


@pytest.mark.parametrize("weights", [None, dict(color=0.0, opacity=2.0)])
def test_build_importance_grid_matches(sphere, weights):
    js, ts = sphere
    jw = None if weights is None else jimp.ImportanceWeights(**weights)
    tw = None if weights is None else timp.ImportanceWeights(**weights)
    want = jstep.build_importance_grid(js, JPipelineConfig(), weights=jw)
    got = tstep.build_importance_grid(ts, PipelineConfig(), weights=tw)
    assert tuple(got.data.shape) == (4, 4, 4)
    assert float(got.data.max()) > 0.0 and float(got.data.min()) == 0.0
    _grid_close(got, want)


def test_build_importance_grid_time_varying_matches():
    seq = synthetic.time_varying_sequence(16, steps=2)
    js, ts = _scenes(seq[1])
    jprev = jminmax.volume_min_max(jtypes.Volume.from_data(seq[0]), 8).data
    diff = np.random.default_rng(5).random((2, 2, 2)).astype(np.float32)
    want = jstep.build_importance_grid(js, JPipelineConfig(),
                                       prev_minmax=jprev,
                                       volume_diff=jnp.asarray(diff))
    got = tstep.build_importance_grid(ts, PipelineConfig(),
                                      prev_minmax=_t(np.asarray(jprev)),
                                      volume_diff=_t(diff))
    assert float(got.data.max()) > 0.0
    _grid_close(got, want)


def test_screen_space_weight_is_not_ported(sphere):
    """The camera-visibility term at the default camera, whose rays cross
    every visible cell of the sphere's grid: the weighted grid equals the
    unweighted one and the reference's weighted grid
    (tests/test_torch_screen_importance.py holds a camera that sees a
    corner)."""
    js, ts = sphere
    want = jstep.build_importance_grid(js, JPipelineConfig(),
                                       screen_space_weight=0.5)
    got = tstep.build_importance_grid(ts, PipelineConfig(),
                                      screen_space_weight=0.5)
    assert float(got.data.max()) > 0.0
    _grid_close(got, want)
    assert torch.equal(got.data, tstep.build_importance_grid(
        ts, PipelineConfig()).data)


def test_tf_change_importance_grid_matches_and_localizes(sphere):
    """A TF edit confined to high density values gives importance only in
    cells that hold those values; the self-difference grid is exactly 0
    (tests/test_pipeline.py:153-181)."""
    js, ts = sphere
    pos = np.array([0.0, 0.45, 0.55, 1.0], np.float32)
    col_a = np.array([[0, 0, 0, 0], [0, 0, 0, 0],
                      [1, 1, 1, 0.5], [1, 1, 1, 0.5]], np.float32)
    col_b = np.array([[0, 0, 0, 0], [0, 0, 0, 0],
                      [1, 0.2, 0.2, 0.9], [1, 0.2, 0.2, 0.9]], np.float32)
    jcfg, tcfg = JPipelineConfig(), PipelineConfig()

    self_grid = tstep.build_tf_change_importance_grid(
        ts, tcfg, ts.tf.positions, ts.tf.colors)
    assert float(self_grid.data.max()) == 0.0

    js_b, ts_b = _scenes(synthetic.sphere_in_box(32), (pos, col_b))
    want = jstep.build_tf_change_importance_grid(
        js_b, jcfg, jnp.asarray(pos), jnp.asarray(col_a))
    # Previous points as numpy arrays and as tensors: the same grid.
    got = tstep.build_tf_change_importance_grid(ts_b, tcfg, pos, col_a)
    got_t = tstep.build_tf_change_importance_grid(ts_b, tcfg, _t(pos),
                                                  _t(col_a))
    np.testing.assert_array_equal(got.data.numpy(), got_t.data.numpy())
    _grid_close(got, want)
    imp = got.data.numpy()
    assert imp.max() > 0.0
    mm = np.asarray(jminmax.volume_min_max(js.volume, 8).data)
    assert imp[mm[..., 1] < 0.45].max() == 0.0

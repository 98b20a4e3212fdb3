"""The port's screen-space importance (``ops/screen_importance.py``)
against the JAX reference and the reference's own checks
(tests/test_screen_importance.py), and ``build_importance_grid`` with
``screen_space_weight`` (CPU, 32^3 sphere, 8-voxel cells, 24^2-64^2
rays)."""

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
from cpm_tpu.io import synthetic
from cpm_tpu.ops import intersect as jintersect
from cpm_tpu.ops import minmax as jminmax
from cpm_tpu.ops import screen_importance as jsi
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import camera as tcamera
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import PipelineConfig, RenderConfig
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import minmax as tminmax
from cpm_tpu_torch.ops import screen_importance as tsi
from cpm_tpu_torch.pipeline import step as tstep

# Per-pixel DDA of the same rays in two frameworks: float32 rounding.
PIXEL_ATOL = 1e-5
# The numpy quadrature oracle of the reference's test.
ORACLE_ATOL = 0.02
# Cell visibility: floor(p * gdim) of a sample that lies on a cell face
# can round to either side in XLA and in torch; a flipped sample marks a
# neighbouring cell. At most this share of the cells may differ.
MAX_FLIPPED_CELLS = 0.02

CAMERAS = {"default": {}, "side": dict(eye=(-1.4, 0.3, 0.6)),
           "far": dict(eye=(0.5, 0.5, -3.0), fov_y=60.0),
           "above": dict(eye=(0.6, 2.1, 0.4), up=(0.0, 0.0, 1.0)),
           "corner": dict(eye=(0.2, 0.25, -3.0), center=(0.2, 0.25, 0.5),
                          fov_y=6.0)}
TFS = {
    "default": synthetic.default_tf_points(),
    "zero_ends": ([0.2, 0.8], [(1, 1, 1, 0.0), (1, 1, 1, 0.5)]),
    "open_ends": ([0.1, 0.5, 0.7], [(1, 1, 1, 0.3), (1, 1, 1, 0.0),
                                    (1, 1, 1, 0.2)]),
    "zero_high": ([0.0, 0.4, 0.9], [(1, 1, 1, 0.4), (1, 1, 1, 0.6),
                                    (1, 1, 1, 0.0)]),
}


@pytest.fixture(scope="module")
def setup():
    """The min/max grids of both packages, 8-voxel cells (4^3) and 4-voxel
    cells (8^3)."""
    data = synthetic.sphere_in_box(32)
    jvol = jtypes.Volume.from_data(data)
    tvol = ttypes.Volume.from_data(data, device="cpu")
    grids = {}
    for cell in (8, 4):
        jmm = jminmax.volume_min_max(jvol, cell)
        tmm = tminmax.volume_min_max(tvol, cell)
        np.testing.assert_array_equal(tmm.data.numpy(), np.asarray(jmm.data))
        grids[cell] = jmm, tmm
    return grids


def _tfs(name):
    return (jtypes.TransferFunction.from_points(*TFS[name]),
            ttypes.TransferFunction.from_points(*TFS[name], device="cpu"))


def _cams(name):
    return (jcamera.Camera.create(**CAMERAS[name]),
            tcamera.Camera.create(device="cpu", **CAMERAS[name]))


@pytest.mark.parametrize("tf", sorted(TFS))
def test_threshold_and_visibility_grid_match(setup, tf):
    jmm, tmm = setup[4]
    jtf, ttf = _tfs(tf)
    want = np.asarray(jsi.data_threshold_from_tf(jtf))
    got = tsi.data_threshold_from_tf(ttf)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tsi.visibility_grid(tmm, got).numpy(),
        np.asarray(jsi.visibility_grid(jmm, jnp.asarray(want))))


def test_threshold_endpoint_rules():
    """tests/test_screen_importance.py: a zero-alpha start moves the low
    edge in, a positive-alpha end keeps the full range."""
    _, ttf = _tfs("zero_ends")
    lo, hi = tsi.data_threshold_from_tf(ttf).tolist()
    assert lo == pytest.approx(0.2) and hi == pytest.approx(1.0)


def test_visibility_grid_culls(setup):
    _, tmm = setup[8]
    vis = tsi.visibility_grid(tmm, torch.tensor([0.5, 1.0])).numpy()
    np.testing.assert_array_equal(vis == 0.0, tmm.data[..., 1].numpy() < 0.5)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_screen_space_importance_matches(setup, cam):
    jmm, tmm = setup[8]
    jtf, ttf = _tfs("default")
    jcam, tcam = _cams(cam)
    want = np.asarray(jsi.screen_space_importance(jmm, jtf, jcam, width=24,
                                                  height=20))
    got = tsi.screen_space_importance(tmm, ttf, tcam, width=24, height=20)
    assert got.shape == (20, 24) and want.max() > 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL)


def test_screen_space_importance_matches_quadrature_oracle(setup):
    """The reference's numpy oracle: dense quadrature of the visibility
    indicator along each pixel's span."""
    _, tmm = setup[8]
    _, ttf = _tfs("default")
    _, cam = _cams("default")
    w = h = 24
    imp = tsi.screen_space_importance(tmm, ttf, cam, width=w,
                                      height=h).numpy()
    vis = tsi.visibility_grid(tmm, tsi.data_threshold_from_tf(ttf)).numpy()
    origins, dirs = cam.rays(w, h)
    o = origins.reshape(-1, 3).numpy()
    d = dirs.reshape(-1, 3).numpy()
    hit, t0, t1 = (np.asarray(x) for x in jintersect.ray_box(
        jnp.asarray(o), jnp.asarray(d)))
    t0 = np.maximum(t0, 0.0)
    S = 4096
    gz, gy, gx = vis.shape
    ref = np.zeros(o.shape[0], np.float32)
    for i in range(o.shape[0]):
        if not hit[i] or t1[i] <= t0[i]:
            continue
        ts = t0[i] + (t1[i] - t0[i]) * (np.arange(S) + 0.5) / S
        p = o[i] + ts[:, None] * d[i]
        c = np.clip((p * [gx, gy, gz]).astype(int), 0,
                    [gx - 1, gy - 1, gz - 1])
        ref[i] = vis[c[:, 2], c[:, 1], c[:, 0]].mean() * (t1[i] - t0[i])
    np.testing.assert_allclose(imp.reshape(-1), ref, atol=ORACLE_ATOL)


def test_miss_pixels_are_zero(setup):
    _, tmm = setup[8]
    _, ttf = _tfs("default")
    _, cam = _cams("far")
    imp = tsi.screen_space_importance(tmm, ttf, cam, width=32,
                                      height=32).numpy()
    assert imp[0, 0] == 0.0 and imp.max() > 0.0


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_cell_visibility_matches(setup, cam):
    """On 8^3 cells with the TF whose window culls the empty cells."""
    jmm, tmm = setup[4]
    jtf, ttf = _tfs("zero_ends")
    jcam, tcam = _cams(cam)
    want = np.asarray(jsi.cell_visibility_from_camera(jmm, jtf, jcam))
    got = tsi.cell_visibility_from_camera(tmm, ttf, tcam).numpy()
    assert got.shape == tmm.data.shape[:3]
    assert set(np.unique(got)).issubset({0.0, 1.0})
    assert 0.0 < got.sum() < got.size
    flipped = int((got != want).sum())
    print(f"{cam}: {int(want.sum())} cells marked, {flipped} differ")
    assert flipped <= MAX_FLIPPED_CELLS * got.size


def test_build_importance_grid_mix():
    """Mixing never raises importance and downweights exactly by 1 - w
    where no camera ray passes (tests/test_screen_importance.py:88-112);
    the grid matches the reference's. The camera sees one corner of the
    volume."""
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.sphere_in_box(32)),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create(**CAMERAS["corner"]))
    jcfg = JPipelineConfig(photons_x=8, photons_y=8,
                           render=JRenderConfig(width=8, height=8))
    tcfg = PipelineConfig(photons_x=8, photons_y=8,
                          render=RenderConfig(width=8, height=8))
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    leaves = {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                       for k in path): np.asarray(leaf)
              for path, leaf in flat}
    tscene = convert.scene_from_numpy(leaves, scene.lights, device="cpu")
    base = tstep.build_importance_grid(tscene, tcfg).data.numpy()
    for w in (0.5, 1.0):
        mixed = tstep.build_importance_grid(tscene, tcfg,
                                            screen_space_weight=w)
        m = mixed.data.numpy()
        assert (m <= base + 1e-6).all()
        vis = tsi.cell_visibility_from_camera(
            tminmax.volume_min_max(tscene.volume,
                                   tcfg.recompute.grid_cell_size),
            tscene.tf, tscene.camera).numpy()
        np.testing.assert_allclose(m, base * ((1 - w) + w * vis), rtol=1e-5)
        want = np.asarray(jstep.build_importance_grid(
            scene, jcfg, screen_space_weight=w).data)
        np.testing.assert_allclose(m, want, rtol=1e-5, atol=1e-6)
    assert 0 < vis.sum() < vis.size

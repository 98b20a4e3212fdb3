"""The port's min/max grid, macrocell majorants, block-exit distances and
empty-space distance map against the JAX reference (CPU, volumes from
numpy seeds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import types as jtypes
from cpm_tpu.io import synthetic
from cpm_tpu.ops import majorant as jmajorant
from cpm_tpu.ops import minmax as jminmax
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.ops import majorant as tmajorant
from cpm_tpu_torch.ops import minmax as tminmax

TF_POINTS = {
    "default": synthetic.default_tf_points(),
    "band": ([0.0, 0.3, 0.35, 0.6, 1.0],
             [(0.2, 0.2, 0.2, 0.0), (0.2, 0.2, 0.2, 0.0),
              (0.9, 0.8, 0.7, 0.5), (0.9, 0.8, 0.7, 0.0),
              (1.0, 1.0, 1.0, 0.0)]),
}


def _volumes(data):
    return (jtypes.Volume.from_data(data),
            ttypes.Volume.from_data(data, device="cpu"))


def _tfs(name):
    pos, cols = TF_POINTS[name]
    return (jtypes.TransferFunction.from_points(pos, cols),
            ttypes.TransferFunction.from_points(pos, cols, device="cpu"))


@pytest.mark.parametrize("dim", [16, 24])
@pytest.mark.parametrize("cell", [4, 8])
def test_min_max_grid_equal(dim, cell):
    """Tolerance: equal (sides that are multiples of the cell size)."""
    jvol, tvol = _volumes(synthetic.smoke_cloud(dim, seed=dim + cell))
    want = jminmax.volume_min_max(jvol, cell)
    got = tminmax.volume_min_max(tvol, cell)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.cell_dim.numpy(),
                                  np.asarray(want.cell_dim))
    np.testing.assert_array_equal(got.volume_dim.numpy(),
                                  np.asarray(want.volume_dim))


@pytest.mark.parametrize("shape,cell", [((20, 20, 20), 8),
                                        ((20, 13, 9), 4)])
def test_min_max_cells_start_at_voxel_0(shape, cell):
    """Sides that are not multiples of the cell size: cells start at voxel
    0 and the last one is partial (the original volumeMinMaxKernel), held
    against a plain numpy loop. Tolerance: equal."""
    data = np.random.default_rng(5).random(shape).astype(np.float32)
    got = tminmax.volume_min_max(
        ttypes.Volume.from_data(data, device="cpu"), cell).data
    g = [-(-s // cell) for s in shape]
    assert tuple(got.shape) == (*g, 2)
    for z in range(g[0]):
        for y in range(g[1]):
            for x in range(g[2]):
                block = data[z * cell:(z + 1) * cell, y * cell:(y + 1) * cell,
                             x * cell:(x + 1) * cell]
                assert got[z, y, x, 0] == block.min()
                assert got[z, y, x, 1] == block.max()


@pytest.mark.parametrize("dim", [16, 24])
@pytest.mark.parametrize("tf_name,rings", [("default", 1), ("band", 1),
                                           ("band", 2)])
def test_majorant_grid_equal(dim, tf_name, rings):
    """Tolerance: equal."""
    jvol, tvol = _volumes(synthetic.smoke_cloud(dim, seed=2))
    jtf, ttf = _tfs(tf_name)
    want = jmajorant.build_majorant_grid(jvol, jtf, 4, rings)
    got = tmajorant.build_majorant_grid(tvol, ttf, 4, rings)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dim", [16, 24])
@pytest.mark.parametrize("cap", [1, 3, 6])
def test_empty_distance_grid_equal(dim, cap):
    """Mostly-empty majorant grid with a few occupied cells. Tolerance:
    equal."""
    rs = np.random.default_rng(dim * cap)
    maj = np.where(rs.random((dim // 2, dim // 4, dim // 2)) < 0.03,
                   rs.random((dim // 2, dim // 4, dim // 2)), 0.0)
    maj = maj.astype(np.float32)
    want = jmajorant.empty_distance_grid(jnp.asarray(maj), cap=cap)
    got = tmajorant.empty_distance_grid(torch.from_numpy(maj), cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dilate_and_opacity_range_max_equal():
    """Tolerance: equal."""
    rs = np.random.default_rng(9)
    a, b = rs.random((2, 5, 6, 7)).astype(np.float32)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    for rings in (1, 2):
        for got, want in zip(
                tmajorant.dilate_min_max(torch.from_numpy(lo),
                                         torch.from_numpy(hi), rings),
                jmajorant.dilate_min_max(jnp.asarray(lo), jnp.asarray(hi),
                                         rings)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in TF_POINTS:
        jtf, ttf = _tfs(name)
        np.testing.assert_array_equal(
            tmajorant.opacity_range_max(ttf, torch.from_numpy(lo),
                                        torch.from_numpy(hi)).numpy(),
            np.asarray(jmajorant.opacity_range_max(jtf, jnp.asarray(lo),
                                                   jnp.asarray(hi))))


@pytest.mark.parametrize("ring", [0, 1, 2])
def test_block_exit_distance_matches(ring):
    """Tolerance: rtol 1e-6, atol 1e-6 (one float32 division)."""
    rs = np.random.default_rng(ring)
    o = rs.uniform(0.0, 1.0, (500, 3)).astype(np.float32)
    d = rs.normal(size=(500, 3)).astype(np.float32)
    d[:50, 1] = 0.0  # axis-parallel
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cell = rs.integers(0, 4, (500, 3)).astype(np.int32)
    ext = np.array([0.25, 0.125, 0.25], np.float32)
    want = jmajorant.block_exit_distance(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(cell), jnp.asarray(ext),
                                         ring=ring)
    got = tmajorant.block_exit_distance(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(cell.astype(np.int64)), torch.from_numpy(ext),
        ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

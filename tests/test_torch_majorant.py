"""The port's min/max grid, macrocell majorants, block-exit distances and
empty-space distance map against the JAX reference (CPU, volumes from
numpy seeds); and the grids in the form the trace's pre-pass builds them
(``csrc/woodcock_trace.cu``'s trace_grids kernels) against the port's
plain grids and the reference's."""

import itertools

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
from cpm_tpu_torch.ops import tracer as ttracer
from test_torch_trace_kernel import GRID_CASES, grid_case, tf_of

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


# --- the grids as the trace's pre-pass builds them ---------------------------


def _cells_min_max(vol: torch.Tensor, cell: int):
    """Each macrocell's (min, max): the sides padded to whole cells with
    +inf and -inf, one reduction a cell (cells start at voxel 0)."""
    pads = []
    for s in reversed(vol.shape):
        pads += [0, -(-s // cell) * cell - s]
    g = [-(-s // cell) for s in vol.shape]

    def reduce(fill, fn):
        v = torch.nn.functional.pad(vol, pads, value=fill)
        v = v.reshape(g[0], cell, g[1], cell, g[2], cell)
        return fn(fn(fn(v, 5), 3), 1)

    return (reduce(float("inf"), lambda t, a: torch.amin(t, a)),
            reduce(float("-inf"), lambda t, a: torch.amax(t, a)))


def _window(x: torch.Tensor, r: int, fill: float, fn) -> torch.Tensor:
    """``fn`` over the (2r+1)^3 window of each cell, windows clipped."""
    g = x.shape
    p = torch.nn.functional.pad(x, [r] * 6, value=fill)
    out = None
    for dz, dy, dx in itertools.product(range(2 * r + 1), repeat=3):
        v = p[dz:dz + g[0], dy:dy + g[1], dx:dx + g[2]]
        out = v if out is None else fn(out, v)
    return out


def _opacity_by_compares(pos, opa, x):
    """The TF opacity at x as the kernels evaluate it: the last segment s
    (of the first P - 1) with x >= pos[s] found by compares, then that one
    segment's lerp; the first opacity where none holds."""
    sel = torch.full(x.shape, -1, dtype=torch.int64)
    for s in range(pos.shape[0] - 1):
        sel = torch.where(x >= pos[s], s, sel)
    s0 = sel.clamp(min=0)
    s1 = (s0 + 1).clamp(max=pos.shape[0] - 1)
    ps = pos[s0]
    t = torch.clamp((x - ps) / torch.clamp(pos[s1] - ps, min=1e-12), 0.0,
                    1.0)
    cs = opa[s0]
    return torch.where(sel >= 0, cs + (opa[s1] - cs) * t, opa[0])


def _grids_as_the_kernels_build_them(data, tf, cfg):
    """(maj, dist, maj_global) in the form of csrc/woodcock_trace.cu's
    trace_grids kernels: cell min/max, dilation, the range's largest
    opacity by compares, and the distance as its x part along each row of
    cells, then the least over the rows (dz, dy) within the cap of
    max(|dz|, |dy|, x part), eroded by one and capped."""
    vol = torch.from_numpy(data)
    pos, opa = tf.positions, tf.colors[:, 3]
    lo, hi = _cells_min_max(vol, cfg.majorant_cell_size)
    r = cfg.block_ring
    lo = _window(lo, r, float("inf"), torch.minimum)
    hi = _window(hi, r, float("-inf"), torch.maximum)
    m = torch.maximum(_opacity_by_compares(pos, opa, lo),
                      _opacity_by_compares(pos, opa, hi))
    for s in range(pos.shape[0]):
        inside = (pos[s] >= lo) & (pos[s] <= hi)
        m = torch.where(inside, torch.maximum(m, opa[s]), m)
    maj = torch.clamp(m, min=0.0) * ttypes.f32_scalar(cfg.tau_max)
    cap = cfg.empty_jump_cap
    nz = (maj > 0.0).numpy()
    gz, gy, gx = nz.shape
    dx = np.where(nz, 0, cap + 1)
    for k in range(cap, 0, -1):
        near = np.zeros_like(nz)
        near[:, :, k:] |= nz[:, :, :-k] if k < gx else False
        near[:, :, :-k] |= nz[:, :, k:] if k < gx else False
        dx = np.where(near & (dx > k), k, dx)
    best = np.full(nz.shape, cap + 1)
    for dz_, dy_ in itertools.product(range(-cap, cap + 1), repeat=2):
        z0, z1 = max(0, -dz_), min(gz, gz - dz_)
        y0, y1 = max(0, -dy_), min(gy, gy - dy_)
        if z0 >= z1 or y0 >= y1:
            continue
        k = np.maximum(max(abs(dz_), abs(dy_)),
                       dx[z0 + dz_:z1 + dz_, y0 + dy_:y1 + dy_])
        best[z0:z1, y0:y1] = np.minimum(best[z0:z1, y0:y1], k)
    dist = np.minimum(cap, np.maximum(best - 1, 0)).astype(np.float32)
    return maj, torch.from_numpy(dist), torch.amax(maj)


def _bits_equal(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (what, int((~same).sum()))


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_the_pre_pass_form_equals_the_plain_grids_and_the_reference(case):
    """The grids in the trace pre-pass's form, bit for bit against the
    port's plain ``majorant_grids_torch`` (NaN where it has NaN); and,
    where every side is a multiple of the cell (the reference's min/max
    cells are shifted elsewhere), no voxel is NaN and the TF has at most 64
    points (the reference's compile unrolls it: minutes at 256), against
    the JAX
    ``_majorant_grids``: distances exactly, majorants and their largest
    within two float32 ulps (XLA's fused CPU code rounds the TF's segment
    lerp in a few cells one ulp otherwise, tests/test_torch_trace_kernel.py,
    and the product by tau_max = 1.25 can make that two)."""
    from cpm_tpu.core.config import TracerConfig as JTracerConfig
    from cpm_tpu.ops import tracer as jtracer

    data, vol, tf, cfg = grid_case(case, "cpu")
    got = _grids_as_the_kernels_build_them(data, tf, cfg)
    want = ttracer.majorant_grids_torch(vol, tf, cfg)
    for g, w, name in zip(got, want, ("maj", "dist", "maj_global")):
        _bits_equal(g.numpy(), w.numpy(), name)
    kw = GRID_CASES[case]
    if any(s % kw["cell"] for s in kw["shape"]) or kw.get("nans") \
            or kw["tf"] > 64:
        return
    jcfg = JTracerConfig(majorant_cell_size=kw["cell"],
                         block_ring=kw["ring"], empty_jump_cap=kw["cap"],
                         tau_max=cfg.tau_max)
    jmaj, jdist, jmax, _ = jtracer._majorant_grids(
        jtypes.Volume.from_data(data),
        jtypes.TransferFunction.from_points(*tf_of(kw["tf"])), jcfg)
    _bits_equal(got[1].numpy(), jdist, "distance vs the reference")
    np.testing.assert_array_max_ulp(got[0].numpy(), np.asarray(jmaj),
                                    maxulp=2)
    np.testing.assert_array_max_ulp(got[2].numpy(), np.asarray(jmax),
                                    maxulp=2)

"""The brick geometry and plain binning behind the tiled splat design
(``cpm_tpu_torch/kernels/splat_product.py``), on the CPU: brick keys,
counts and segments, halo and shared-memory sizes, the design choice, and
that splatting brick by brick gives the whole splat. The CUDA kernels
follow the same integer geometry; ``chip_smoke.py`` holds them against
these plain versions on the card."""

import math

import numpy as np
import pytest
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.kernels import splat_product as sp

FLT_MAX = np.float32(3.4028235e38)
# Brick-wise sum vs the whole plain splat: the same float32 terms summed in
# another order.
BRICK_RTOL, BRICK_ATOL = 1e-5, 1e-7

GRIDS = [(65, 65, 65), (17, 23, 29)]
RN = [0.5, 1.0, 2.5]  # radius in cells of the longest axis


def _radius(dim, rn):
    return float(np.float32(rn / max(dim)))


def _deposits(m, seed, dim, sentinel_frac=0.25):
    """Seeded positions in [0, 1), then rows exactly on cell and brick
    borders, on and beyond the box's faces, and unused slots."""
    rs = np.random.default_rng(seed)
    pos = rs.random((m, 3), dtype=np.float32)
    d, h, w = dim
    n = np.array([w, h, d], np.float32)
    borders = []
    for cell in (0, 1, 7, 8, 9, 15, 16):
        c = np.minimum(np.float32(cell), n - 1)
        borders.append(c / n)  # exactly on a cell (and brick) border
        borders.append(np.nextafter(c / n, np.float32(0)))
        borders.append((c + np.float32(0.5)) / n)
    borders += [np.zeros(3, np.float32), np.ones(3, np.float32),
                np.full(3, -0.01, np.float32), np.full(3, 1.01, np.float32),
                np.array([0.5, -3.0, 7.0], np.float32)]
    pos = np.concatenate([pos, np.stack(borders).astype(np.float32)])
    pw = rs.uniform(-1.0, 2.0, pos.shape).astype(np.float32)
    unused = rs.random(pos.shape[0]) < sentinel_frac
    pos[unused] = FLT_MAX
    pw[unused] = 0.0
    return torch.from_numpy(pos), torch.from_numpy(pw)


def _axis_window(p, r, n):
    """The kernels' inclusive cell window of a support along one axis, in
    float32 as ``csrc/splat_product.cu: axis_window`` computes it; empty
    windows come back with lo > hi."""
    p, r, n = np.float32(p), np.float32(r), np.float32(n)
    lo = np.maximum(np.floor((p - r) * n - np.float32(0.5)), 0)
    hi = np.minimum(np.ceil((p + r) * n - np.float32(0.5)), n - 1)
    return lo.astype(np.int64), hi.astype(np.int64)


@pytest.mark.parametrize("dim", GRIDS)
def test_bricks_per_axis_and_count(dim):
    nb = sp.bricks_per_axis(dim)
    assert nb == tuple(math.ceil(n / sp.BRICK) for n in dim)
    assert sp.brick_count(dim) == nb[0] * nb[1] * nb[2]
    assert sp.brick_count((65, 65, 65)) == 729


@pytest.mark.parametrize("dim", GRIDS)
@pytest.mark.parametrize("rn", RN)
def test_halo_tile_and_shared_memory(dim, rn):
    r = _radius(dim, rn)
    h = sp.halo_cells(r, dim)
    assert h == math.ceil(float(np.float32(r)) * max(dim) + 0.51)
    assert h >= rn + 0.5
    t = sp.tile_cells(r, dim)
    assert t == sp.BRICK + 2 * h
    assert sp.tile_smem_bytes(r, dim) == t ** 3 * 3 * 4
    assert sp.window_width(r, dim) <= 2 * h + 1 + 1
    assert sp.kernel_width(r, dim) in sp.WINDOW_WIDTHS
    assert sp.kernel_width(r, dim) >= sp.window_width(r, dim)
    assert sp.tiled_fits(r, dim)


def test_default_frame_geometry():
    """The default frame: r n = 1.0001 at 65^3 gives a 2-cell halo, 12^3
    tiles of 20,736 bytes and windows of at most 5 cells."""
    dim, r = (65, 65, 65), 0.0153866
    assert sp.halo_cells(r, dim) == 2
    assert sp.tile_cells(r, dim) == 12
    assert sp.tile_smem_bytes(r, dim) == 20736
    assert sp.kernel_width(r, dim) == 5


def test_tile_that_does_not_fit_is_refused():
    dim = (65, 65, 65)
    r = 12.0 / 65  # halo 13 cells: a 34^3 tile, 471,648 bytes
    assert sp.tile_smem_bytes(r, dim) > sp.SMEM_BYTES
    assert not sp.tiled_fits(r, dim)
    assert sp.choose_design(1 << 24, r, dim) == "direct"
    assert sp.kernel_width(r, dim) == 0


def test_design_choice_follows_density():
    dim, r = (65, 65, 65), 0.0153866
    cells = 65 ** 3
    edge = int(sp.TILED_MIN_DEPOSITS_PER_CELL * cells)
    assert sp.choose_design(262144, r, dim) == "direct"
    assert sp.choose_design(16777216, r, dim) == "tiled"
    assert sp.choose_design(edge - 1, r, dim) == "direct"
    assert sp.choose_design(edge + 1, r, dim) == "tiled"
    assert sp.choose_design(0, r, dim) == "direct"


@pytest.mark.parametrize("m", [0, 1, 1000, 262144, 16777216])
def test_count_chunk_and_work_items(m):
    chunk = sp.count_chunk(m)
    assert chunk % sp.COUNT_THREADS == 0 and 1024 <= chunk <= 8192
    dim = (65, 65, 65)
    # Worst case: every brick holds one more deposit than full items.
    assert sp.max_work_items(m, dim) >= min(m, 729)
    assert sp.max_work_items(m, dim) <= 729 + m // sp.SEGMENT


@pytest.mark.parametrize("dim", GRIDS)
def test_brick_keys_on_borders_and_sentinels(dim):
    pos, _ = _deposits(500, seed=11, dim=dim)
    keys = sp.brick_keys(pos, dim).numpy()
    p = pos.numpy()
    d, h, w = dim
    nbz, nby, nbx = sp.bricks_per_axis(dim)
    unused = ~(p[:, 0] < 1e30)
    assert unused.sum() > 50 and (keys[unused] == -1).all()
    live = ~unused
    n = np.array([w, h, d], np.float32)
    cell = np.clip(np.floor(p[live] * n), 0, n - 1).astype(np.int64)
    b = cell // sp.BRICK
    want = (b[:, 2] * nby + b[:, 1]) * nbx + b[:, 0]
    np.testing.assert_array_equal(keys[live], want)
    assert keys[live].min() >= 0 and keys.max() < nbz * nby * nbx
    # A position exactly on a brick border belongs to the upper brick, the
    # float just below it to the lower one.
    on = torch.tensor([[8 / w, 8 / h, 8 / d]], dtype=torch.float32)
    below = torch.from_numpy(np.nextafter(on.numpy(), np.float32(0)))
    assert int(sp.brick_keys(on, dim)) == (1 * nby + 1) * nbx + 1
    assert int(sp.brick_keys(below, dim)) == 0


@pytest.mark.parametrize("dim", GRIDS)
def test_plain_binning_counts_and_segments(dim):
    pos, _ = _deposits(3000, seed=5, dim=dim)
    counts, offsets, order = sp.bin_deposits_torch(pos, dim)
    keys = sp.brick_keys(pos, dim)
    nb = sp.brick_count(dim)
    assert counts.shape == (nb,) and offsets.shape == (nb + 1,)
    assert int(counts.sum()) == int((keys >= 0).sum()) == order.shape[0]
    assert int(offsets[0]) == 0 and int(offsets[-1]) == order.shape[0]
    np.testing.assert_array_equal(np.diff(offsets.numpy()), counts.numpy())
    # Every live deposit exactly once, each in its own brick's segment.
    np.testing.assert_array_equal(
        np.sort(order.numpy()), np.nonzero(keys.numpy() >= 0)[0])
    for b in range(nb):
        seg = order[int(offsets[b]):int(offsets[b + 1])]
        assert bool((keys[seg] == b).all())


@pytest.mark.parametrize("dim", GRIDS)
@pytest.mark.parametrize("rn", RN)
def test_every_window_stays_inside_its_bricks_tile(dim, rn):
    """The brick key and the window of cells a deposit reaches agree: no
    window leaves the tile (brick plus halo) of the deposit's brick, and
    none is wider than the kernels keep weights for."""
    r = _radius(dim, rn)
    pos, _ = _deposits(4000, seed=9, dim=dim)
    keys = sp.brick_keys(pos, dim).numpy()
    live = keys >= 0
    p = pos.numpy()[live]
    nbz, nby, nbx = sp.bricks_per_axis(dim)
    k = keys[live]
    brick = {0: k % nbx, 1: (k // nbx) % nby, 2: k // (nbx * nby)}
    halo, width = sp.halo_cells(r, dim), sp.kernel_width(r, dim)
    d, h, w = dim
    for axis, n in ((0, w), (1, h), (2, d)):
        lo, hi = _axis_window(p[:, axis], r, n)
        some = lo <= hi
        assert some.sum() > 1000
        first = brick[axis][some] * sp.BRICK - halo
        assert (lo[some] >= first).all()
        assert (hi[some] < first + sp.tile_cells(r, dim)).all()
        assert (hi[some] - lo[some] + 1 <= width).all()


@pytest.mark.parametrize("dim", GRIDS)
@pytest.mark.parametrize("rn", RN)
def test_splat_by_brick_segments_sums_to_the_whole(dim, rn):
    """The plain splat restricted to each brick's segment, summed over the
    bricks, is the plain splat of the whole list; and each segment's splat
    is zero outside its brick's tile."""
    r = _radius(dim, rn)
    pos, pw = _deposits(600, seed=21, dim=dim)
    whole = sp.splat_product_torch(pos, pw, r, dim)
    counts, offsets, order = sp.bin_deposits_torch(pos, dim)
    nbz, nby, nbx = sp.bricks_per_axis(dim)
    halo = sp.halo_cells(r, dim)
    total = torch.zeros_like(whole)
    for b in torch.nonzero(counts)[:, 0].tolist():
        seg = order[int(offsets[b]):int(offsets[b + 1])]
        part = sp.splat_product_torch(pos[seg], pw[seg], r, dim)
        total += part
        inside = torch.zeros(dim, dtype=torch.bool)
        lo = [c * sp.BRICK - halo for c in
              (b // (nbx * nby), (b // nbx) % nby, b % nbx)]
        inside[tuple(slice(max(o, 0), o + sp.tile_cells(r, dim))
                     for o in lo)] = True
        assert not bool(part[~inside].any())
    torch.testing.assert_close(total, whole, rtol=BRICK_RTOL,
                               atol=BRICK_ATOL)


@pytest.mark.parametrize("fn", ["direct", "tiled", "bin"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    """A kernel wrapper launches or raises: CPU tensors reach the plain
    version only through ``splat_product``."""
    pos, pw = _deposits(16, seed=2, dim=(8, 8, 8))
    with pytest.raises(ValueError):
        if fn == "bin":
            sp.bin_deposits(pos, (8, 8, 8))
        else:
            getattr(sp, f"splat_product_{fn}")(pos, pw, 0.1, (8, 8, 8))
    assert telemetry.launches("splat_product_direct") == 0
    assert telemetry.launches("splat_product_tiled") == 0
    assert telemetry.launches("bin_deposits") == 0

"""The splat's backward kernel: a Python mirror of each slot's work in
``splat_grad_kernel`` (the cells of nonzero weight inside the window it
walks, gathered z, then y, then x) summed against the plain backward, the
wrapper's host path, and (on a card only) the kernel against the plain
version. The file imports no JAX, so its card tests run
on a machine without the reference: ``python -m pytest -p
no:cacheprovider --noconftest -m cuda tests/test_torch_splat_grad.py``.
The backward's plain version is held against the reference's ``jax.grad``
in ``tests/test_torch_splat.py`` and ``tests/test_torch_grad.py``."""

import numpy as np
import pytest
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.kernels import splat_product as sp

FLT_MAX = np.float32(3.4028235e38)
R, DIM = 0.0153866, (65, 65, 65)  # the default frame's radius and grid
# The rows' sums against the dense plain version: the same float32 terms
# added in another order.
ROWS_RTOL, ROWS_ATOL_REL = 1e-5, 1e-6
# The kernel against the plain version on the card: float32 sums in
# another order (chip_smoke.py holds the same).
CARD_RTOL, CARD_ATOL_REL = 1e-4, 1e-6


def _grid_grad(dim, seed):
    rs = np.random.default_rng(seed)
    return torch.from_numpy(rs.standard_normal((*dim, 3)).astype(np.float32))


def _list(kind: str):
    """(positions (M, 3) float32 numpy, radius, grid) of one test list."""
    rs = np.random.default_rng(sum(map(ord, kind)))
    if kind.startswith("m="):
        m = int(kind[2:])
        pos = rs.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
        pos[rs.random(m) < 0.5] = FLT_MAX
        return pos, R, DIM
    if kind == "dead interleaved":
        # FLT_MAX, NaN and float16's +inf widened, between live slots.
        pos = rs.uniform(0.0, 1.0, (1024, 3)).astype(np.float32)
        pos[1::4] = FLT_MAX
        pos[2::8] = np.nan
        pos[6::8] = np.inf
        return pos, R, DIM
    if kind == "all dead":
        pos = np.full((700, 3), FLT_MAX, np.float32)
        pos[::3] = np.inf
        return pos, R, DIM
    if kind == "all live":
        return rs.uniform(0.0, 1.0, (768, 3)).astype(np.float32), R, DIM
    if kind == "faces and corners":
        # Deposits on and just beyond the grid's faces, edges and corners:
        # windows clamped on one, two or three axes, some missing the grid.
        pick = np.array([-0.01, 0.0, 0.004, 0.5, 0.996, 1.0, 1.01],
                        np.float32)
        pos = pick[rs.integers(0, pick.size, (600, 3))]
        return pos + rs.uniform(-1e-3, 1e-3, (600, 3)).astype(np.float32), \
            0.07, (17, 23, 29)
    if kind == "wide (W = 0)":
        # r * n = 4: windows of 10 cells, wider than the kernel keeps
        # weights for.
        pos = rs.uniform(-0.05, 1.05, (300, 3)).astype(np.float32)
        pos[rs.random(300) < 0.3] = FLT_MAX
        return pos, 0.25, (16, 16, 16)
    raise KeyError(kind)


LISTS = ["dead interleaved", "all dead", "all live", "faces and corners",
         "wide (W = 0)", "m=1", "m=255", "m=257", "m=0"]


def _dead(pos: torch.Tensor) -> torch.Tensor:
    return ~(pos[:, 0] < 1e30)


def _weight(cell: torch.Tensor, n: int, p: torch.Tensor,
            inv_r: float) -> torch.Tensor:
    """The kernels' axis weight K(((i + 0.5) / n - p) / r) of cells i."""
    dist = (sp.voxel_centres(n, p.device)[cell] - p) * inv_r
    return torch.clamp(0.75 * (1.0 - dist * dist), min=0.0)


def _nonzero_cells(positions: torch.Tensor, r: float, dim):
    """The cells each slot's gather adds (the kernel walks its window and
    skips the zero weights): per axis (x, y, z), the first cell of nonzero
    weight and the number of them, (M, 3) each; 0 cells on every axis for
    an unused slot or one whose support misses the grid on some axis. Also
    the dense nonzero masks, (M, n) per axis."""
    inv_r = float(sp.inverse_radius(r))
    used = positions[:, 0] < 1e30
    first, cells, masks = [], [], []
    for axis, n in enumerate((dim[2], dim[1], dim[0])):
        nz = _weight(torch.arange(n)[None, :], n,
                     positions[:, axis, None], inv_r) > 0.0
        nz &= used[:, None]
        f = torch.argmax(nz.to(torch.int8), dim=1)
        last = n - 1 - torch.argmax(nz.flip(1).to(torch.int8), dim=1)
        any_ = nz.any(dim=1)
        first.append(torch.where(any_, f, 0))
        cells.append(torch.where(any_, last - f + 1, 0))
        masks.append(nz)
    first, cells = torch.stack(first, 1), torch.stack(cells, 1)
    has = (cells > 0).all(dim=1, keepdim=True)
    return torch.where(has, first, 0), torch.where(has, cells, 0), masks


def _grad_by_rows(positions: torch.Tensor, grad: torch.Tensor, r: float,
                  dim) -> torch.Tensor:
    """The backward summed as the kernel sums it: each slot's cells of
    nonzero weight, z then y then x, a term (Kz Ky) Kx G at a time. (M, 3);
    0 for a slot with no cell."""
    inv_r = float(sp.inverse_radius(r))
    first, cells, _ = _nonzero_cells(positions, r, dim)
    out = torch.zeros((positions.shape[0], 3), dtype=torch.float32)
    if positions.shape[0] == 0:
        return out
    d, h, w = dim
    for jz in range(int(cells[:, 2].max())):
        for jy in range(int(cells[:, 1].max())):
            for jx in range(int(cells[:, 0].max())):
                on = ((jz < cells[:, 2]) & (jy < cells[:, 1])
                      & (jx < cells[:, 0]))
                z = torch.where(on, first[:, 2] + jz, 0)
                y = torch.where(on, first[:, 1] + jy, 0)
                x = torch.where(on, first[:, 0] + jx, 0)
                a = (_weight(z, d, positions[:, 2], inv_r)
                     * _weight(y, h, positions[:, 1], inv_r))
                wgt = a * _weight(x, w, positions[:, 0], inv_r)
                term = wgt[:, None] * grad[z, y, x]
                out += torch.where(on[:, None], term, 0.0)
    return out


def _axis_window(p: np.ndarray, r: float, n: int):
    """The kernels' axis_window in float32: the cells [lo, hi] a deposit's
    window scans on one axis, clamped to the grid (lo > hi: none)."""
    p, r, n32 = np.float32(p), np.float32(r), np.float32(n)
    with np.errstate(invalid="ignore", over="ignore"):
        lo = np.maximum(np.floor((p - r) * n32 - np.float32(0.5)), 0.0)
        hi = np.minimum(np.ceil((p + r) * n32 - np.float32(0.5)), n - 1.0)
    return lo, hi


@pytest.mark.parametrize("kind", LISTS)
def test_rows_of_the_partition_sum_to_the_plain_gradient(kind):
    """Every slot's cells of nonzero weight summed term by term in the
    kernel's order equal the plain backward; an unused slot gets exactly 0 (the
    plain version gives NaN at a NaN position: 0 * NaN in its dense
    sums)."""
    pos, r, dim = _list(kind)
    tpos = torch.from_numpy(pos)
    g = _grid_grad(dim, seed=1)
    got = _grad_by_rows(tpos, g, r, dim)
    want = sp.splat_product_grad_torch(tpos, g, r, dim)
    assert got.shape == (pos.shape[0], 3)
    dead = _dead(tpos)
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    ok = ~torch.isnan(tpos).any(dim=1)
    scale = float(want[ok].abs().max()) if bool(ok.any()) else 0.0
    torch.testing.assert_close(got[ok], want[ok], rtol=ROWS_RTOL,
                               atol=ROWS_ATOL_REL * scale)
    if kind == "all dead":
        assert not bool(got.any())
    if kind in ("all live", "dead interleaved", "wide (W = 0)"):
        assert bool((got[~dead] != 0).any())


@pytest.mark.parametrize("kind", LISTS)
def test_nonzero_cells_lie_in_the_window_the_kernel_scans(kind):
    """The cells of nonzero weight of each axis are one run, and it lies
    inside the kernel's axis_window, which holds at most W cells where the
    kernel keeps W weights (W = 0 only where no width of the kernels holds
    the windows): the window the kernel walks drops no term."""
    pos, r, dim = _list(kind)
    tpos = torch.from_numpy(pos)
    first, cells, masks = _nonzero_cells(tpos, r, dim)
    live = (cells > 0).all(dim=1)
    width = sp.kernel_width(r, dim)
    assert (width == 0) == (kind == "wide (W = 0)")
    assert not bool(live[_dead(tpos)].any())
    for axis, n in enumerate((dim[2], dim[1], dim[0])):
        cell = torch.arange(n)[None, :]
        run = (cell >= first[:, axis, None]) & (
            cell < (first + cells)[:, axis, None])
        assert torch.equal(masks[axis] & live[:, None], run)
        lo, hi = _axis_window(pos[:, axis], r, n)
        f = first[:, axis].numpy()[live.numpy()]
        last = f + cells[:, axis].numpy()[live.numpy()] - 1
        lo, hi = lo[live.numpy()], hi[live.numpy()]
        assert (lo <= f).all() and (last <= hi).all()
        if width:
            assert (hi - lo + 1 <= width).all()


def test_rows_cover_the_default_frames_windows():
    """At the default frame's radius (r * n = 1.0001) a live deposit has 2
    cells of nonzero weight per axis, rarely 3: 8 terms of the 5 x 5 x 5
    window the kernel walks."""
    pos, r, dim = _list("all live")
    _, cells, _ = _nonzero_cells(torch.from_numpy(pos), r, dim)
    live = (cells > 0).all(dim=1)
    cells = cells[live]
    assert int(cells.min()) >= 1 and int(cells.max()) <= 3
    assert float((cells <= 2).all(dim=1).double().mean()) > 0.99


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "meta",
                                 "radius", "out_dim", "grid float64",
                                 "grid shape", "grid strided"])
def test_backward_wrapper_checks_each_input_once(bad, monkeypatch):
    """Every check of the backward runs once a call and raises as before
    on what it does not take."""
    pos, r, dim = _list("m=255")
    tpos = torch.from_numpy(pos)
    dim = (8, 8, 8)
    g = _grid_grad(dim, seed=2)
    calls = {"deposits": 0, "grid": 0}
    check_deposits, check_grid_grad = sp._check_deposits, sp._check_grid_grad

    def counted_deposits(*a):
        calls["deposits"] += 1
        return check_deposits(*a)

    def counted_grid(*a):
        calls["grid"] += 1
        return check_grid_grad(*a)

    monkeypatch.setattr(sp, "_check_deposits", counted_deposits)
    monkeypatch.setattr(sp, "_check_grid_grad", counted_grid)
    sp.splat_product_grad(tpos, g, r, dim)
    assert calls == {"deposits": 1, "grid": 1}
    if bad == "float64":
        tpos = tpos.double()
    elif bad == "shape":
        tpos = tpos[:, :2].contiguous()
    elif bad == "strided":
        tpos = torch.cat([tpos, tpos], dim=1)[:, ::2]
    elif bad == "meta":
        tpos = tpos.to("meta")
    elif bad == "radius":
        r = float("nan")
    elif bad == "out_dim":
        dim = (8, 0, 8)
    elif bad == "grid float64":
        g = g.double()
    elif bad == "grid shape":
        g = g[:4]
    else:
        g = g.transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        sp.splat_product_grad(tpos, g, r, dim)


def test_backward_wrapper_launches_nothing_on_the_cpu():
    pos, r, dim = _list("dead interleaved")
    tpos = torch.from_numpy(pos)
    g = _grid_grad(dim, seed=3)
    before = telemetry.launches("splat_product_grad_cuda")
    got = sp.splat_product_grad(tpos, g, r, dim)
    assert telemetry.launches("splat_product_grad_cuda") == before
    torch.testing.assert_close(
        got, sp.splat_product_grad_torch(tpos, g, r, dim), rtol=0, atol=0,
        equal_nan=True)
    with pytest.raises(ValueError, match="CUDA"):
        sp.splat_product_grad_cuda(tpos, g, r, dim)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _on_card(tpos, g, r, dim):
    """The kernel through the wrapper, twice: (result, second result); the
    launch counter goes up by one a call."""
    before = telemetry.launches("splat_product_grad_cuda")
    got = sp.splat_product_grad(tpos, g, r, dim)
    again = sp.splat_product_grad(tpos, g, r, dim)
    torch.cuda.synchronize()
    assert telemetry.launches("splat_product_grad_cuda") == before + 2
    return got, again


def _held(got, tpos, g, r, dim):
    dead = _dead(tpos)
    assert not bool(got[dead].any())
    ok = ~torch.isnan(tpos).any(dim=1)
    ref = sp.splat_product_grad_torch(tpos, g, r, dim)
    scale = float(ref[ok].abs().max()) if bool(ok.any()) else 0.0
    torch.testing.assert_close(got[ok], ref[ok], rtol=CARD_RTOL,
                               atol=CARD_ATOL_REL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", LISTS)
def test_backward_kernel_matches_plain_on_each_list(cuda_device, kind):
    """On the card: the kernel against the plain version on every list of
    the CPU tests; two launches are bit-equal."""
    pos, r, dim = _list(kind)
    tpos = torch.from_numpy(pos).to(cuda_device)
    g = _grid_grad(dim, seed=4).to(cuda_device)
    got, again = _on_card(tpos, g, r, dim)
    assert torch.equal(got, again)
    _held(got, tpos, g, r, dim)
    rows = _grad_by_rows(tpos.cpu(), g.cpu(), r, dim)
    torch.testing.assert_close(
        got.cpu(), rows, rtol=CARD_RTOL,
        atol=1e-6 * float(rows.abs().max()) if rows.numel() else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["misaligned", "more than one wave"])
def test_backward_kernel_at_the_edges_of_its_launch(cuda_device, case):
    """On the card: a positions view 12 bytes past an aligned allocation,
    4,194,304 slots (more tiles of 256 than the card keeps blocks resident,
    so each block strides over many), each against the plain version and
    bit-equal twice."""
    rs = np.random.default_rng(5)
    m = 4194304 if case == "more than one wave" else 262144 + 17
    pos = rs.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    pos[rs.random(m) < 0.8] = FLT_MAX
    tpos = torch.from_numpy(pos).to(cuda_device)
    if case == "misaligned":
        base = torch.empty((m + 1, 3), dtype=torch.float32,
                           device=cuda_device)
        base[1:] = tpos
        tpos = base[1:]
        assert tpos.data_ptr() % 16 == 12 and tpos.is_contiguous()
    g = _grid_grad(DIM, seed=6).to(cuda_device)
    got, again = _on_card(tpos, g, R, DIM)
    assert torch.equal(got, again)
    _held(got, tpos, g, R, DIM)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [(8, 8, 12300), (2, 2, 58200)])
def test_backward_kernel_on_long_axes(cuda_device, dim):
    """On the card: a block keeps the grid's d + h + w cell centres in
    shared memory. Past 48 KB of them (12,316 centres) the launch asks for
    more and the kernel holds against the plain version; past a block's
    227 KB (58,204) the wrapper raises and launches nothing."""
    rs = np.random.default_rng(8)
    pos = rs.uniform(-0.05, 1.05, (300, 3)).astype(np.float32)
    pos[rs.random(300) < 0.3] = FLT_MAX
    tpos = torch.from_numpy(pos).to(cuda_device)
    g = _grid_grad(dim, seed=9).to(cuda_device)
    r = 0.1
    assert sp.kernel_width(r, dim) == 0
    if 4 * sum(dim) > sp.SMEM_BYTES:
        before = telemetry.launches("splat_product_grad_cuda")
        with pytest.raises(ValueError, match="shared memory"):
            sp.splat_product_grad(tpos, g, r, dim)
        assert telemetry.launches("splat_product_grad_cuda") == before
        return
    assert 4 * sum(dim) > 48 * 1024
    got, again = _on_card(tpos, g, r, dim)
    assert torch.equal(got, again)
    assert bool((got != 0).any())
    _held(got, tpos, g, r, dim)


@pytest.mark.cuda
def test_backward_wrapper_enters_no_device_context(cuda_device,
                                                   monkeypatch):
    """On the card: with the tensors on the current device the wrapper
    launches without entering ``torch.cuda.device``."""
    pos, r, dim = _list("all live")
    tpos = torch.from_numpy(pos).to(cuda_device)
    g = _grid_grad(dim, seed=7).to(cuda_device)
    torch.cuda.set_device(cuda_device)

    def refuse(*_):
        raise AssertionError("entered a device context")

    with monkeypatch.context() as patched:
        patched.setattr(torch.cuda.device, "__enter__", refuse)
        got = sp.splat_product_grad(tpos, g, r, dim)
    torch.cuda.synchronize()
    _held(got, tpos, g, r, dim)

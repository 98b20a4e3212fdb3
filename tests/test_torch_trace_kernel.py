"""The trace's two forms and what they share (``ops/tracer.py``):

- ``method`` dispatch: CPU tensors under "auto" take the wavefront loop,
  "cuda" on CPU tensors and an unknown method raise;
- ``trace_constants`` against the reference's own values for the same
  scene, bit for bit (``build_trace_tables``' global majorant and cell
  extent, the distance grid and the scalars of
  ``cpm_tpu/ops/tracer.py:290-347``; the majorant grid within one ulp),
  on a scene whose sides are multiples
  of the cell size (ROADMAP queue 3, item 1: elsewhere the reference's
  min/max cells are shifted);
- the premise of the kernel's lane-local loop: a trace in chunks of one
  lane equals the trace in one piece bit for bit, at K = 1, 2, 3 flights
  per test of the loop condition, with a ``max_steps`` that stops lanes;
  and so does a trace of the lanes in another order, or of any partition
  of them with their lane ids, which is what the kernel's compaction and
  refill rest on;
- the wrapper's pure parts: the launch shape (with a mirror of the
  kernel's compaction and claims, every lane runs exactly once), the
  macrocell divisor, the grids' table, and the byte rule that places the
  transfer functions in shared or in device memory before a launch;
- on the card (marked ``cuda``): the kernel against the wavefront loop,
  lane by lane, for every option, on 1 and 33 lanes, on a grid too
  small for its list (refill), with a transfer function of 8192
  points (past 48 KB of shared memory), with two of 40,000 points (past a
  block's shared memory: read from device memory) and with the default
  ones read from device memory; the grids' pre-pass against its plain
  version bit for bit (the cases of :data:`GRID_CASES`, which
  tests/test_torch_majorant.py also holds against the reference).

The reference is imported inside the tests that use it, so that the card
tests also run where JAX is not installed (``--noconftest``).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import TracerConfig
from cpm_tpu_torch.core.lights import Light
from cpm_tpu_torch.io import synthetic
from cpm_tpu_torch.kernels import woodcock_trace as wt
from cpm_tpu_torch.ops import emit, phase, rng, sampling, tracer


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread beside JAX's pool (tests/test_torch_emission.py
    measured ~8x on this box's cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(shape, device="cpu", seed=6):
    """A smoke cloud of ``shape`` (D, H, W), default TFs, and directional
    light samples on a 12^2 grid."""
    d, h, w = shape
    data = synthetic.smoke_cloud(max(shape), seed=seed)[:d, :h, :w]
    vol = ttypes.Volume.from_data(np.ascontiguousarray(data), device=device)
    tf = ttypes.TransferFunction.from_points(*synthetic.default_tf_points(),
                                             device=device)
    tfs = ttypes.TransferFunction.from_points(
        *synthetic.default_scattering_points(), device=device)
    ls = emit.emit(Light.directional((0.0, -1.0, 0.3)),
                   sampling.stratified_grid_2d(12, 12, device=device))
    return vol, tf, tfs, ls


# --- dispatch ----------------------------------------------------------------


def test_auto_runs_the_wavefront_on_cpu_tensors(monkeypatch):
    vol, tf, tfs, ls = _scene((8, 8, 8))
    cfg = TracerConfig(max_interactions=2, max_steps=200)
    ran = []
    wavefront = tracer._trace_wavefront
    monkeypatch.setattr(tracer, "_trace_wavefront",
                        lambda *a: ran.append(1) or wavefront(*a))
    launches = telemetry.launches("trace_woodcock_cuda")
    got = tracer.trace_photons(vol, tf, tfs, ls, (0, 3), cfg)
    chunked = tracer.trace_photons_chunked(vol, tf, tfs, ls, (0, 3), cfg,
                                           chunk=50)
    want = tracer.trace_photons(vol, tf, tfs, ls, (0, 3), cfg,
                                method="wavefront")
    assert len(ran) == 1 + 3 + 1
    assert telemetry.launches("trace_woodcock_cuda") == launches
    for f in ("positions", "powers", "directions", "exit_power",
              "exit_direction"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(getattr(chunked, f), getattr(want, f)), f
    assert int((got.positions[..., 0] < 1e30).sum()) > 10


@pytest.mark.parametrize("method", ["cuda", "triton", "kernel", ""])
def test_cuda_on_cpu_tensors_and_unknown_methods_raise(method):
    vol, tf, tfs, ls = _scene((8, 8, 8))
    cfg = TracerConfig(max_interactions=2, max_steps=200)
    with pytest.raises(ValueError):
        tracer.trace_photons(vol, tf, tfs, ls, (0, 3), cfg, method=method)
    with pytest.raises(ValueError):
        tracer.trace_photons_chunked(vol, tf, tfs, ls, (0, 3), cfg, chunk=50,
                                     method=method)


def test_kernel_wrapper_refuses_cpu_tensors():
    vol, tf, tfs, ls = _scene((8, 8, 8))
    c = tracer.trace_constants(vol, tf, tfs, TracerConfig())
    with pytest.raises(ValueError):
        wt.trace_woodcock_cuda(
            c, vol.data, ls.origins, ls.directions, ls.powers, ls.tspan,
            torch.arange(ls.n), (0, 3))


# --- the constants against the reference -------------------------------------

CONSTANT_CASES = {
    "default": dict(),
    "clip_hg_ring2": dict(block_ring=2, clip_min=(0.1, 0.0, 0.2),
                          clip_max=(0.9, 1.0, 0.8), phase_type=1,
                          phase_g=0.3, tau_max=1.5, sampling_rate=3.0,
                          max_steps=7, flights_per_iteration=3),
    "no_grid": dict(use_majorant_grid=False, empty_jump_cap=3,
                    majorant_cell_size=4, max_steps=0),
}


@pytest.mark.parametrize("case", sorted(CONSTANT_CASES))
def test_trace_constants_equal_the_references(case):
    """Every constant the trace reads, bit for bit against the values the
    reference computes (float32 scalars rounded as its jnp arithmetic
    rounds them), on a 16 x 24 x 32 scene (sides multiples of 8 and 4)."""
    import jax.numpy as jnp
    from cpm_tpu.core import types as jtypes
    from cpm_tpu.core.config import TracerConfig as JTracerConfig
    from cpm_tpu.core import constants as jconstants
    from cpm_tpu.ops import tracer as jtracer

    kw = CONSTANT_CASES[case]
    vol, tf, tfs, _ = _scene((16, 24, 32))
    jvol = jtypes.Volume.from_data(vol.data.numpy())
    jtf = jtypes.TransferFunction.from_points(*synthetic.default_tf_points())
    jcfg, cfg = JTracerConfig(**kw), TracerConfig(**kw)
    c = tracer.trace_constants(vol, tf, tfs, cfg)
    tables = jtracer.build_trace_tables(jvol, jtf, jcfg)
    maj, dist, _, _ = jtracer._majorant_grids(jvol, jtf, jcfg)

    def same(got, want, what):
        want = np.asarray(want, np.float32)
        got = np.asarray(got, np.float32)
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=what)

    same(c.maj_global.numpy(), tables.maj_global, "maj_global")
    same(c.cell_min_ext, tables.cell_min_ext, "cell_min_ext")
    # The grids themselves: the distances exactly; the majorants within one
    # float32 ulp, as XLA's fused CPU code rounds the TF's segment lerp in
    # a few cells differently from the one rounding per operation of both
    # torch and the kernel (the global max above is bit-equal).
    same(c.dist.numpy(), dist, "distance grid")
    np.testing.assert_array_max_ulp(c.maj.numpy(), np.asarray(maj),
                                    maxulp=1)
    # The scalars of cpm_tpu/ops/tracer.py:290-347, computed as there.
    d_, h_, w_ = jvol.data.shape
    vdims = jnp.array([w_, h_, d_], jnp.float32)
    cell_vox = jnp.int32(jcfg.majorant_cell_size)
    same(c.vdims, vdims, "vdims")
    same(c.cell_ext, cell_vox.astype(jnp.float32) / vdims, "cell_ext")
    same(c.step_size, jnp.float32(
        1.0 / (jcfg.sampling_rate * max(jvol.data.shape))), "step_size")
    same(c.sbi, jnp.float32(jconstants.SAMPLING_BASE_INTERVAL_RCP), "sbi")
    same(c.clip_min, jnp.asarray(jcfg.clip_min, jnp.float32), "clip_min")
    same(c.clip_max, jnp.asarray(jcfg.clip_max, jnp.float32), "clip_max")
    same(c.phase_g, jnp.float32(jcfg.phase_g), "phase_g")
    assert c.clipped == (jcfg.clip_min != (0.0, 0.0, 0.0)
                         or jcfg.clip_max != (1.0, 1.0, 1.0))
    assert c.shape == (16, 24, 32) and c.ring == jcfg.block_ring
    assert c.cell_vox == jcfg.majorant_cell_size
    assert c.phase_type == jcfg.phase_type
    # The loop's exit test every K flights: the step limit is max_steps
    # rounded up to a multiple of K.
    k = max(1, jcfg.flights_per_iteration)
    assert c.flights == k and c.step_limit % k == 0
    assert c.step_limit - k < jcfg.max_steps <= c.step_limit
    same(c.tf_pos.numpy(), synthetic.default_tf_points()[0], "tf points")
    same(c.tf_opa.numpy(), np.asarray(synthetic.default_tf_points()[1])[:, 3],
         "tf opacities")
    same(c.tfs_opa.numpy(),
         np.asarray(synthetic.default_scattering_points()[1])[:, 3],
         "scattering tf opacities")


# --- the lane-local premise --------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_one_lane_at_a_time_equals_the_whole_trace(k):
    """A trace in chunks of one lane runs each lane's own loop: while it is
    active and its step is below K * ceil(max_steps / K). It equals the
    trace of all lanes together bit for bit, with max_steps = 10 stopping
    lanes that are still active (the whole trace runs to the step limit)."""
    vol, tf, tfs, ls = _scene((16, 16, 16))
    cfg = TracerConfig(max_interactions=3, max_steps=10,
                       flights_per_iteration=k)
    key = rng.fold_in(rng.prng_key(5), 0)
    ids = torch.arange(ls.n, dtype=torch.int64) * 3 + 11
    whole, stats = tracer.trace_photons(vol, tf, tfs, ls, key, cfg,
                                        lane_ids=ids, return_stats=True)
    limit = k * -(-cfg.max_steps // k)
    assert stats["wavefront_iters"] == limit
    assert int(stats["active_history"][limit - 1]) > 0
    lanes = tracer.trace_photons_chunked(vol, tf, tfs, ls, key, cfg,
                                         chunk=1, lane_ids=ids)
    for f in ("positions", "powers", "directions", "exit_power",
              "exit_direction"):
        assert torch.equal(getattr(lanes, f), getattr(whole, f)), f
    assert int((whole.positions[..., 0] < 1e30).sum()) > 20
    # A longer limit moves the lanes it stopped.
    longer = tracer.trace_photons(
        vol, tf, tfs, ls, key, dataclasses.replace(cfg, max_steps=400),
        lane_ids=ids)
    assert not torch.equal(longer.positions, whole.positions)


@pytest.mark.parametrize("order", ["permuted", "partitioned"])
def test_a_reordered_or_partitioned_trace_equals_the_whole_trace(order):
    """The lanes traced in a seeded permutation, or as a seeded partition
    into three traces each with its lanes' ids, give every lane the bits
    of the trace of all of them in order: a lane's draws depend on its id
    and its own step only, which is what lets the kernel compact its lanes
    and refill freed threads in any order."""
    vol, tf, tfs, ls = _scene((16, 16, 16))
    cfg = TracerConfig(max_interactions=3, max_steps=40)
    key = rng.fold_in(rng.prng_key(7), 1)
    ids = torch.arange(ls.n, dtype=torch.int64) * 5 + 2
    whole = tracer.trace_photons(vol, tf, tfs, ls, key, cfg, lane_ids=ids)
    gen = torch.Generator().manual_seed(11)

    def subset(sel):
        sub = ttypes.LightSamples(
            origins=ls.origins[sel], directions=ls.directions[sel],
            powers=ls.powers[sel], tspan=ls.tspan[sel])
        return tracer.trace_photons(vol, tf, tfs, sub, key, cfg,
                                    lane_ids=ids[sel])

    if order == "permuted":
        parts = [torch.randperm(ls.n, generator=gen)]
    else:
        part = torch.randint(0, 3, (ls.n,), generator=gen)
        parts = [torch.nonzero(part == k)[:, 0] for k in range(3)]
        assert all(len(p) > 10 for p in parts)
    for sel in parts:
        got = subset(sel)
        for f in ("positions", "powers", "directions"):
            assert torch.equal(getattr(got, f),
                               getattr(whole, f)[:, sel]), f
        for f in ("exit_power", "exit_direction"):
            assert torch.equal(getattr(got, f), getattr(whole, f)[sel]), f
    assert int((whole.positions[..., 0] < 1e30).sum()) > 20


def _run_schedule(shape: wt.LaunchShape, n: int, flights: np.ndarray):
    """A mirror of the trace kernel's loop over lanes: each block starts
    with its first lanes; with compaction, every ``compact_every`` flights
    (blocks taking their turns) it keeps its live lanes and its free
    threads take the lanes a shared counter hands out past the grid's own,
    until the counter passes n and the block holds no lane. Returns how
    many times each lane started."""
    started = np.zeros(n, np.int64)
    left = {}  # block -> flights left of each lane it holds

    def start(lane):
        started[lane] += 1
        return int(flights[lane])

    for b in range(shape.grid):
        left[b] = [start(i) for i in range(min(b * shape.block, n),
                                           min((b + 1) * shape.block, n))]
    if not shape.compact_every:
        return started
    claimed_from = shape.grid * shape.block
    counter, more = 0, {b: True for b in left}
    while left:
        for b in list(left):
            live = [f - shape.compact_every for f in left[b]
                    if f - shape.compact_every > 0]
            free = shape.block - len(live)
            claim = None
            if more[b] and free:
                got, counter = counter, counter + free
                if got < n - claimed_from:
                    claim = got
                else:
                    more[b] = False
            if claim is not None:
                lanes = range(claimed_from + claim,
                              min(claimed_from + claim + free, n))
                live += [start(i) for i in lanes]
            if not live and claim is None:
                del left[b]
            else:
                left[b] = live
    return started


@pytest.mark.parametrize("n,sms,per_sm,k", [
    (1, 132, 8, 8), (33, 132, 8, 8), (6656, 132, 8, 8), (65536, 132, 8, 8),
    (300000, 132, 8, 0), (300000, 132, 8, 8), (5000, 4, 2, 2),
    (70001, 4, 3, 1)])
def test_launch_shape_runs_every_lane_once(n, sms, per_sm, k, monkeypatch):
    """The launch of a list: the widest block that gives every SM a block;
    compaction (and claims) only in blocks wider than a warp and where the
    list needs more blocks than the card keeps resident, which is then the
    grid; and every lane started exactly once, by its block or by a
    claim."""
    monkeypatch.setattr(wt, "COMPACT_EVERY", k)
    shape = wt.launch_shape(n, sms, lambda block: per_sm)
    blocks = -(-n // shape.block)
    assert shape.block in wt.BLOCKS
    assert blocks >= sms or shape.block == wt.BLOCKS[-1]
    if shape.block == 32 or k == 0 or blocks <= sms * per_sm:
        assert shape.compact_every == 0 and shape.grid == blocks
    else:
        assert shape.compact_every == k and shape.grid == sms * per_sm
    flights = np.random.default_rng(n).integers(0, 60, n)
    assert (_run_schedule(shape, n, flights) == 1).all()


def test_cell_divisor_gives_the_quotient():
    """The kernel's macrocell index: a shift for a power of two, else the
    high word of v times ceil(2^32 / cell), equal to v // cell for every
    voxel index of a volume the wrapper takes."""
    for cell in range(1, 70):
        shift, mul = wt._cell_divisor(cell, (4096, 17, 9))
        v = np.concatenate([np.arange(5000), np.arange(4096 - 300, 4096)])
        got = v >> shift if shift >= 0 else (v * mul) >> 32
        assert (got == v // cell).all(), cell
        assert (shift >= 0) == (cell & (cell - 1) == 0)
    with pytest.raises(ValueError):
        wt._cell_divisor(3, (2 ** 31, 1, 1))


def test_the_kernels_table_of_the_grids():
    """The kernel reads one (gz, gy, gx, 2) table: the pre-pass's own where
    the grids are its halves, else the two grids stacked."""
    table = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(
        3, 4, 5, 2)
    assert wt._table(table[..., 0], table[..., 1]).data_ptr() == \
        table.data_ptr()
    maj, dist = table[..., 0].contiguous(), table[..., 1].contiguous()
    assert torch.equal(wt._table(maj, dist), table)


@pytest.mark.parametrize("below", [0, 1])
def test_the_transfer_functions_leave_shared_memory_past_the_limit(
        below, monkeypatch):
    """The wrapper's rule, at the byte boundary of a limit passed in: a
    trace block keeps both transfer functions' points (8 bytes a point) in
    shared memory while they and its staging area (24 words a thread) fit
    in the limit, and reads them from device memory one byte past it,
    with the opacities contiguous; the occupancy that sizes the grid is
    asked for the shared memory of the form launched. The grids' rule
    likewise with a row of cells (4 bytes a cell)."""
    vol, tf, tfs, ls = _scene((16, 16, 16))
    pos, cols = tf_of(60)
    tf = ttypes.TransferFunction.from_points(pos, cols, device="cpu")
    points = 60 + tfs.positions.shape[0]
    sms = 2
    block = wt.launch_shape(ls.n, sms, lambda b: 1).block
    limit = 8 * points + 4 * wt.LANE_WORDS * block - below
    asked = []

    def per_sm(index, b, smem, tf_global):
        asked.append((b, smem, tf_global))
        return 1

    monkeypatch.setattr(wt, "shared_limit", lambda index, kernel: limit)
    monkeypatch.setattr(wt, "_per_sm", per_sm)
    monkeypatch.setattr(wt, "_sms", lambda index: sms)
    monkeypatch.setattr(wt, "_device_index", lambda dev: 0)
    c = tracer.trace_constants(vol, tf, tfs, TracerConfig())
    ids = torch.arange(ls.n, dtype=torch.int64)
    args, shape, _, keep = wt._prepare(
        c, vol.data.contiguous(), ls.origins.contiguous(),
        ls.directions.contiguous(), ls.powers.contiguous(),
        ls.tspan.contiguous(), ids, (1, 2), 0, False)
    assert shape.block == block
    assert args.tf_global == below
    staging = 4 * wt.LANE_WORDS * block
    assert (block, staging + (0 if below else 8 * points), bool(below)) \
        in asked
    assert all(smem == wt.trace_smem(points, b, not g)
               for b, smem, g in asked)
    if below:
        assert (args.tf_stride, args.tfs_stride) == (1, 1)
        assert args.tf_opa == keep[2].data_ptr() and keep[2].is_contiguous()
        assert torch.equal(keep[2], c.tf_opa)
    else:
        assert (args.tf_stride, args.tfs_stride) == (4, 4)
        assert args.tf_opa == c.tf_opa.data_ptr()
    gx = 64
    assert wt.tf_in_shared(8 * points, 4 * gx, 8 * points + 4 * gx - below) \
        == (not below)


# --- the grids' cases ----------------------------------------------------------

# Volumes and transfer functions the grids are held at: the default frame's
# 128^3 volume, partial last cells (sides 20, 13, 9), a cell of 3 voxels,
# rings 1 and 2, caps 0, 1 and 6, transfer functions of 4, 17, 64, 256,
# 8192 points (past 48 KB of shared memory a block, where the kernel opts
# in to more) and 40,000 (past a block's shared memory: the points read
# from device memory), and volumes that are empty and full everywhere.
GRID_CASES = {
    "default_frame_128": dict(shape=(128, 128, 128), tf=4, cell=8, ring=1,
                              cap=6),
    "partial_cells_20": dict(shape=(20, 20, 20), tf=4, cell=8, ring=1,
                             cap=6),
    "ring2_cap1_tf17": dict(shape=(32, 24, 40), tf=17, cell=4, ring=2,
                            cap=1),
    "cap0_tf64": dict(shape=(40, 32, 24), tf=64, cell=8, ring=1, cap=0),
    "cell3_partial_tf17": dict(shape=(20, 13, 9), tf=17, cell=3, ring=1,
                               cap=6),
    "tf256_ring2": dict(shape=(64, 48, 56), tf=256, cell=8, ring=2, cap=6),
    "tf8192": dict(shape=(16, 24, 16), tf=8192, cell=8, ring=1, cap=6),
    "tf40000": dict(shape=(16, 24, 16), tf=40000, cell=8, ring=1, cap=6),
    "all_empty": dict(shape=(32, 32, 32), fill=0.0, tf=4, cell=8, ring=1,
                      cap=6),
    "all_full": dict(shape=(32, 32, 32), fill=0.7, tf=4, cell=8, ring=1,
                     cap=6),
    "nan_voxels": dict(shape=(24, 24, 24), nans=5, tf=4, cell=8, ring=1,
                       cap=6),
}


def tf_of(points: int):
    """The default transfer function (4 points) or a seeded one of
    ``points``: sorted positions over [0, 1], colours in [0, 1], opacities
    in [0, 0.6] with a fifth of them 0."""
    if points == 4:
        return synthetic.default_tf_points()
    rs = np.random.default_rng(points)
    pos = np.sort(rs.uniform(0.0, 1.0, points)).astype(np.float32)
    pos[0], pos[-1] = 0.0, 1.0
    cols = rs.uniform(0.0, 1.0, (points, 4)).astype(np.float32)
    cols[:, 3] *= 0.6
    cols[rs.random(points) < 0.2, 3] = 0.0
    return pos, cols


def grid_case(name: str, device: str):
    """(volume data as numpy, Volume, TransferFunction, TracerConfig) of a
    case of :data:`GRID_CASES`."""
    kw = GRID_CASES[name]
    d, h, w = kw["shape"]
    if "fill" in kw:
        data = np.full(kw["shape"], kw["fill"], np.float32)
    else:
        data = np.ascontiguousarray(
            synthetic.smoke_cloud(max(kw["shape"]), seed=3)[:d, :h, :w])
        rs = np.random.default_rng(1)
        for _ in range(kw.get("nans", 0)):
            data[tuple(rs.integers(0, s) for s in data.shape)] = np.nan
    vol = ttypes.Volume.from_data(data, device=device)
    tf = ttypes.TransferFunction.from_points(*tf_of(kw["tf"]), device=device)
    cfg = TracerConfig(majorant_cell_size=kw["cell"], block_ring=kw["ring"],
                       empty_jump_cap=kw["cap"], tau_max=1.25)
    return data, vol, tf, cfg


# --- on the card -------------------------------------------------------------

# At most this share of lanes may differ from the plain version on the card
# (expected 0: the kernel rounds as torch does, --fmad=false).
MAX_LANES_DIFFER = 1e-3

CARD_CASES = {
    "default": (dict(), dict()),
    "float16": (dict(photon_dtype="float16", max_interactions=2), dict()),
    "no_single_scattering": (dict(no_single_scattering=True), dict()),
    "stats": (dict(), dict(return_stats=True)),
    "tape": (dict(), dict(record_events=64)),
    "retrace": (dict(), dict(retrace=6656)),
    "hg_clip_k1": (dict(phase_type=phase.HENYEY_GREENSTEIN, phase_g=0.6,
                        clip_min=(0.1, 0.0, 0.2), clip_max=(0.9, 1.0, 0.8),
                        flights_per_iteration=1), dict()),
    "schlick_cut_k3": (dict(phase_type=phase.SCHLICK, phase_g=-0.4,
                            max_steps=20, flights_per_iteration=3),
                       dict(return_stats=True)),
    "chunked": (dict(trace_chunk=10000), dict()),
    "one_lane": (dict(), dict(lanes=1)),
    "33_lanes": (dict(), dict(lanes=33)),
    # A grid too small for the list: its threads take the lanes past it
    # from the counter (block, grid, flights between compactions).
    "refill_stats": (dict(), dict(return_stats=True, shape=(128, 8, 4))),
    "refill_tape_k2": (dict(), dict(record_events=64, shape=(64, 5, 2))),
    "no_compaction": (dict(), dict(return_stats=True, shape=(128, 512, 0))),
    # A transfer function of 8192 points: past 48 KB of shared memory a
    # block, with the staging area of a compaction too; few flights, since
    # the wavefront evaluates every segment.
    "tf8192_points": (dict(max_steps=6, flights_per_iteration=2),
                      dict(tf_points=8192)),
    "tf8192_points_refill": (dict(max_steps=6, flights_per_iteration=2),
                             dict(tf_points=8192, shape=(256, 8, 4))),
    # Both transfer functions of 40,000 points: past a block's shared
    # memory, so the kernel reads them from device memory (fewer flights
    # still: the wavefront's where chain is 40,000 segments long).
    "tf40000_points": (dict(max_steps=4, flights_per_iteration=2),
                       dict(tf_points=40000, tfs_points=40000)),
    "tf40000_points_refill": (dict(max_steps=4, flights_per_iteration=2),
                              dict(tf_points=40000, tfs_points=40000,
                                   shape=(256, 8, 4))),
    # The default transfer functions read from device memory (a limit of
    # 0 bytes), every flight, with the statistics.
    "global_tf_default": (dict(), dict(return_stats=True, tf_limit=0)),
}
# The cases whose transfer functions the kernels read from device memory.
GLOBAL_TF = ("tf40000_points", "tf40000_points_refill", "global_tf_default")


@pytest.fixture(scope="module")
def card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    scene, config = chip_smoke.build_frame()
    from cpm_tpu_torch.pipeline import step
    state = step.init_state(scene, config)
    return scene, config, state


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_the_wavefront_on_the_card(card_frame, case,
                                                  monkeypatch):
    """The default frame (65,536 lanes, 128^3) through the kernel and the
    wavefront loop, lane by lane: at most MAX_LANES_DIFFER of the lanes
    may differ in any bit of a deposit, the exits or the tape; the
    statistics are equal; one launch per trace (per chunk)."""
    import chip_smoke
    scene, config, state = card_frame
    tkw, opts = CARD_CASES[case]
    opts = dict(opts)
    cfg = dataclasses.replace(config.tracer, **tkw)
    samples, ids, tf = state.light_samples, None, scene.tf
    tfs = scene.tf_scattering
    if "tf_points" in opts:
        tf = chip_smoke.many_point_tf(tf, opts.pop("tf_points"))
    if "tfs_points" in opts:
        tfs = chip_smoke.many_point_tf(tfs, opts.pop("tfs_points"), seed=13)
    if "tf_limit" in opts:
        limit = opts.pop("tf_limit")
        monkeypatch.setattr(wt, "shared_limit", lambda index, kernel: limit)
    if "lanes" in opts:
        k = opts.pop("lanes")
        samples = ttypes.LightSamples(
            origins=samples.origins[:k], directions=samples.directions[:k],
            powers=samples.powers[:k], tspan=samples.tspan[:k])
    if "shape" in opts:
        shape = wt.LaunchShape(*opts.pop("shape"))
        monkeypatch.setattr(wt, "launch_shape", lambda n, sms, per_sm: shape)
    if "retrace" in opts:
        gen = torch.Generator().manual_seed(3)
        ids = torch.randperm(samples.n, generator=gen)[:opts.pop("retrace")]
        ids = ids.sort().values.to(samples.origins.device)
        samples = ttypes.LightSamples(
            origins=samples.origins[ids], directions=samples.directions[ids],
            powers=samples.powers[ids], tspan=samples.tspan[ids])
    key = rng.fold_in(state.key, 0)
    args = (scene.volume, tf, tfs, samples, key, cfg)

    def run(method):
        if cfg.trace_chunk:
            return tracer.trace_photons_chunked(
                *args, cfg.trace_chunk, lane_ids=ids, method=method)
        return tracer.trace_photons(*args, lane_ids=ids, method=method,
                                    **opts)

    before = telemetry.launches("trace_woodcock_cuda")
    got = run("cuda")
    torch.cuda.synchronize()
    launches = telemetry.launches("trace_woodcock_cuda") - before
    want = run("wavefront")
    assert telemetry.launches("trace_woodcock_cuda") - before == launches
    assert launches == (-(-samples.n // cfg.trace_chunk)
                        if cfg.trace_chunk else 1)
    assert wt.trace_woodcock_cuda.tf_global == (case in GLOBAL_TF)
    assert wt.trace_grids_cuda.tf_global == (case in GLOBAL_TF)
    differ = chip_smoke.trace_lanes_differ(got, want)
    print(f"{case}: {int(differ.sum())} of {samples.n} lanes differ")
    assert float(differ.float().mean()) <= MAX_LANES_DIFFER
    photons = got[0] if isinstance(got, tuple) else got
    assert photons.positions.dtype == getattr(torch, cfg.photon_dtype)
    if samples.n > 1000:
        assert int((photons.positions[..., 0].float() < 1e30).sum()) > 1000
    if opts.get("return_stats"):
        g, w = got[1], want[1]
        assert g["wavefront_iters"] == w["wavefront_iters"]
        assert torch.equal(g["active_history"], w["active_history"])
        assert torch.equal(g["mean_active_frac"], w["mean_active_frac"])
        assert g["stage_widths"] == w["stage_widths"] == [samples.n]
    if opts.get("record_events"):
        assert torch.equal(got[1].counts, want[1].counts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grids_match_their_plain_version_on_the_card(case):
    """The grids' pre-pass (three launches, one counted call) against
    ``majorant_grids_torch`` on the same card: majorants, distances and
    their largest, bit for bit (NaN where it has NaN); both grids halves
    of the one table the trace kernel reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, vol, tf, cfg = grid_case(case, "cuda")
    before = telemetry.launches("trace_grids_cuda")
    got = tracer.majorant_grids(vol, tf, cfg)
    torch.cuda.synchronize()
    assert telemetry.launches("trace_grids_cuda") == before + 1
    want = tracer.majorant_grids_torch(vol, tf, cfg)
    assert telemetry.launches("trace_grids_cuda") == before + 1
    for g, w, name in zip(got[:3], want[:3], ("maj", "dist", "maj_global")):
        assert g.shape == w.shape and g.device == w.device, name
        g, w = g.contiguous(), w.contiguous()
        same = (g.view(torch.int32) == w.view(torch.int32)) | (
            torch.isnan(g) & torch.isnan(w))
        assert bool(same.all()), (name, int((~same).sum()))
    assert got[3] == want[3]
    assert wt._table(got[0], got[1]).data_ptr() == got[0].data_ptr()
    # Past a block's shared memory (227 KB on an H100) the points are read
    # from device memory.
    assert wt.trace_grids_cuda.tf_global == (GRID_CASES[case]["tf"] > 20000)
    print(f"{case}: grids {tuple(got[0].shape)} equal bit for bit, "
          f"{int((got[0] > 0).sum())} nonzero cells, max "
          f"{float(got[2]):.6g}")

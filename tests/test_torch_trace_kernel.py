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
- on the card (marked ``cuda``): the kernel against the wavefront loop,
  lane by lane, for every option.

The reference is imported inside the tests that use it, so that the card
tests also run where JAX is not installed (``--noconftest``).
"""

import dataclasses

import numpy as np
import pytest
import torch

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
    launches = wt.trace_woodcock_cuda.launches
    got = tracer.trace_photons(vol, tf, tfs, ls, (0, 3), cfg)
    chunked = tracer.trace_photons_chunked(vol, tf, tfs, ls, (0, 3), cfg,
                                           chunk=50)
    want = tracer.trace_photons(vol, tf, tfs, ls, (0, 3), cfg,
                                method="wavefront")
    assert len(ran) == 1 + 3 + 1
    assert wt.trace_woodcock_cuda.launches == launches
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
}


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
def test_kernel_matches_the_wavefront_on_the_card(card_frame, case):
    """The default frame (65,536 lanes, 128^3) through the kernel and the
    wavefront loop, lane by lane: at most MAX_LANES_DIFFER of the lanes
    may differ in any bit of a deposit, the exits or the tape; the
    statistics are equal; one launch per trace (per chunk)."""
    import chip_smoke
    scene, config, state = card_frame
    tkw, opts = CARD_CASES[case]
    cfg = dataclasses.replace(config.tracer, **tkw)
    samples, ids = state.light_samples, None
    if "retrace" in opts:
        gen = torch.Generator().manual_seed(3)
        ids = torch.randperm(samples.n, generator=gen)[:opts.pop("retrace")]
        ids = ids.sort().values.to(samples.origins.device)
        samples = ttypes.LightSamples(
            origins=samples.origins[ids], directions=samples.directions[ids],
            powers=samples.powers[ids], tspan=samples.tspan[ids])
    key = rng.fold_in(state.key, 0)
    args = (scene.volume, scene.tf, scene.tf_scattering, samples, key, cfg)

    def run(method):
        if cfg.trace_chunk:
            return tracer.trace_photons_chunked(
                *args, cfg.trace_chunk, lane_ids=ids, method=method)
        return tracer.trace_photons(*args, lane_ids=ids, method=method,
                                    **opts)

    before = wt.trace_woodcock_cuda.launches
    got = run("cuda")
    torch.cuda.synchronize()
    launches = wt.trace_woodcock_cuda.launches - before
    want = run("wavefront")
    assert wt.trace_woodcock_cuda.launches - before == launches
    assert launches == (-(-samples.n // cfg.trace_chunk)
                        if cfg.trace_chunk else 1)
    differ = chip_smoke.trace_lanes_differ(got, want)
    print(f"{case}: {int(differ.sum())} of {samples.n} lanes differ")
    assert float(differ.float().mean()) <= MAX_LANES_DIFFER
    photons = got[0] if isinstance(got, tuple) else got
    assert photons.positions.dtype == getattr(torch, cfg.photon_dtype)
    assert int((photons.positions[..., 0].float() < 1e30).sum()) > 1000
    if opts.get("return_stats"):
        g, w = got[1], want[1]
        assert g["wavefront_iters"] == w["wavefront_iters"]
        assert torch.equal(g["active_history"], w["active_history"])
        assert torch.equal(g["mean_active_frac"], w["mean_active_frac"])
        assert g["stage_widths"] == w["stage_widths"] == [samples.n]
    if opts.get("record_events"):
        assert torch.equal(got[1].counts, want[1].counts)

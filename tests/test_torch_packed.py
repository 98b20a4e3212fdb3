"""The port's packed interactive frame (``cpm_tpu_torch/pipeline/packed.py``)
against ``cpm_tpu/pipeline/packed.py`` and against the port's own
stagewise pipeline (CPU, 32^3 sphere, 32^2 photons, 2 interactions, a
32^2 image, as tests/test_packed.py):

- the packing is a pure re-layout: a round trip is bit-identical, and
  each leaf packed from a state carried over from the reference equals
  the reference's leaf;
- a frame equals ``correlated_step`` (after the key's ``fold_in(key, 1)``)
  and the sweep render of the camera it is given, bit for bit;
- a frame matches the reference's: the same photons selected and the same
  bookkeeping, lanes compared as ROADMAP sets out (XLA and torch round
  log/exp differently, so 95% of lanes must agree to 1e-4), the image
  within tests/test_packed.py's tolerances;
- ``do_render=False`` and ``fresh_round``.
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
from cpm_tpu.core.config import RecomputeConfig as JRecomputeConfig
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic
from cpm_tpu.pipeline import packed as jpacked
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       RenderConfig, TracerConfig)
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import rng, sweep_render
from cpm_tpu_torch.pipeline import packed as tpacked
from cpm_tpu_torch.pipeline import step as tstep

# Lane by lane against JAX (tests/test_torch_tracer.py): a last-ulp
# difference in log/exp can flip a Woodcock decision and move a lane.
LANE_POS_ATOL, LANE_POW_RTOL, MIN_LANE_FRACTION = 1e-4, 1e-4, 0.95
# tests/test_packed.py:65-68: the image.
IMAGE_RTOL, IMAGE_ATOL = 1e-5, 1e-6
# tests/test_packed.py:62-64 holds the light volume to rtol 1e-6, atol
# 1e-7 within JAX; across the two frameworks the splats sum in another
# order and a moved lane moves its deposits, so the absolute part is
# 1e-5 of the peak (one float32 ulp of the peak is ~6e-8 of it).
LV_RTOL, LV_ATOL_REL = 1e-6, 1e-5

TRACER = dict(max_interactions=2, max_steps=3000)
FIELDS = ("positions", "powers", "directions", "exit_power",
          "exit_direction")


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread beside JAX's pool (tests/test_torch_emission.py
    measured ~8x on this box's cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_of(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def _configs(frac=0.1):
    kw = dict(photons_x=32, photons_y=32)
    jcfg = JPipelineConfig(
        tracer=JTracerConfig(**TRACER),
        render=JRenderConfig(width=32, height=32),
        recompute=JRecomputeConfig(max_photons_fraction=frac), **kw)
    tcfg = PipelineConfig(
        tracer=TracerConfig(**TRACER), render=RenderConfig(width=32,
                                                           height=32),
        recompute=RecomputeConfig(max_photons_fraction=frac), **kw)
    return jcfg, tcfg


def _corner_grid():
    """A grid that flags only the photons through one corner cell: fewer
    than a batch of 512, so the selected set does not depend on the last
    bits of the importance (tests/test_torch_correlated.py)."""
    data = np.zeros((4, 4, 4), np.float32)
    data[0, 3, 0] = 1.0
    return data


@pytest.fixture(scope="module")
def shared():
    """The reference's scene, its state after a full trace and its
    importance grid, and all three carried over to the port."""
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.sphere_in_box(32)),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create())
    jcfg, _ = _configs()
    state = jstep.full_trace_step(scene, jstep.init_state(scene, jcfg), jcfg)
    grid = jstep.build_importance_grid(scene, jcfg)
    tscene = convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                      device="cpu")
    tstate = convert.state_from_numpy(leaves_of(state), device="cpu")
    tgrid = ttypes.UniformGrid3D(
        data=torch.from_numpy(np.array(grid.data)),
        cell_dim=torch.from_numpy(np.array(grid.cell_dim)),
        volume_dim=torch.from_numpy(np.array(grid.volume_dim)))
    return scene, state, grid, tscene, tstate, tgrid


def _state_equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a.photons, f), getattr(b.photons, f)), f
    for f in ("origins", "directions", "powers", "tspan"):
        assert torch.equal(getattr(a.light_samples, f),
                           getattr(b.light_samples, f)), f
    assert torch.equal(a.light_volume, b.light_volume)
    assert torch.equal(a.retraced, b.retraced)
    assert a.key == b.key and a.n_remaining == b.n_remaining
    assert a.recompute_phase == b.recompute_phase
    assert a.photons.iteration == b.photons.iteration
    assert a.photons.radius_rel == b.photons.radius_rel
    assert a.photons.scene_radius == b.photons.scene_radius
    assert a.light_samples.iteration == b.light_samples.iteration


def test_round_trip_is_bit_identical(shared):
    """pack -> unpack gives the state back bit for bit (the progressive
    average becomes the light volume, as in the reference); a float16
    unpack is the float32 fields cast."""
    _, _, _, tscene, tstate, _ = shared
    _, tcfg = _configs()
    state = tstep.full_trace_step(tscene, tstate, tcfg)
    state = dataclasses.replace(
        state, n_remaining=37, recompute_phase=5,
        retraced=torch.arange(state.photons.n) % 3 == 0,
        key=(4294967295, 12345))
    packed = tpacked.pack_state(state)
    back = tpacked.unpack_state(packed)
    _state_equal(back, state)
    assert torch.equal(back.light_volume_accum, state.light_volume)
    half = tpacked.unpack_state(packed, "float16")
    for f in ("positions", "powers", "directions"):
        assert getattr(half.photons, f).dtype == torch.float16
        assert torch.equal(getattr(half.photons, f),
                           getattr(state.photons, f).half())
    assert packed.misc.device.type == packed.key.device.type == "cpu"


def test_pack_state_equals_the_references_leaves(shared):
    _, state, _, _, tstate, _ = shared
    state = state.replace(n_remaining=jnp.int32(37),
                          recompute_phase=jnp.int32(5))
    tstate = dataclasses.replace(tstate, n_remaining=37, recompute_phase=5)
    want = jpacked.pack_state(state)
    got = tpacked.pack_state(tstate)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("camera", ["scene", "side"])
def test_frame_equals_the_stagewise_pipeline(shared, camera):
    """The frame is the key's fold_in(key, 1), correlated_step and the
    sweep render along the camera it is given, bit for bit."""
    _, _, _, tscene, tstate, tgrid = shared
    _, tcfg = _configs()
    cam = tscene.camera if camera == "scene" else Camera.create(
        eye=(2.2, 0.6, 0.4), device="cpu")
    budget = tstep.recompute_budget(tcfg, tstate.photons.n)
    want = tstep.correlated_step(
        tscene, dataclasses.replace(tstate, key=rng.fold_in(tstate.key, 1)),
        tcfg, tgrid, budget)
    want_img = sweep_render.sweep_render(
        tscene.volume, tscene.tf, want.light_volume_accum, cam, tcfg.render)
    if camera == "scene":
        assert torch.equal(want_img, tstep.render_state(tscene, want, tcfg))
    packed, img = tpacked.interactive_frame(
        tscene, tpacked.pack_state(tstate), cam, tgrid, tcfg, budget)
    _state_equal(tpacked.unpack_state(packed), want)
    assert torch.equal(img, want_img)
    assert img.shape == (32, 32, 4) and float(img[..., 3].max()) > 0.0


def _lanes_agree(jsoa, tsoa):
    """Per lane: the same used slots, positions within LANE_POS_ATOL and
    powers within LANE_POW_RTOL."""
    jp, tp = jsoa[..., 0:3], tsoa[..., 0:3]
    jw, tw = jsoa[..., 3:6], tsoa[..., 3:6]
    used = jp[..., 0] < 1e30
    return (np.all(used == (tp[..., 0] < 1e30), axis=0)
            & np.all(np.where(used[..., None], np.abs(jp - tp), 0.0)
                     <= LANE_POS_ATOL, axis=(0, 2))
            & np.all(np.isclose(tw, jw, rtol=LANE_POW_RTOL, atol=0.0),
                     axis=(0, 2)))


def test_frame_matches_the_reference(shared):
    """From the reference's state after a full trace, one fresh-round frame
    in each package (tests/test_packed.py:test_fused_frame_matches_
    stagewise, on a grid whose selection is unambiguous): the same photons
    retraced and the same counters and key; the retraced lanes lane by
    lane; the light volume and the image within the stated tolerances."""
    scene, state, grid, tscene, tstate, tgrid = shared
    jcfg, tcfg = _configs(frac=0.5)
    data = _corner_grid()
    grid = grid.replace(data=jnp.asarray(data))
    tgrid = dataclasses.replace(tgrid, data=torch.from_numpy(data))
    budget = jstep.recompute_budget(jcfg, state.photons.n)
    assert tstep.recompute_budget(tcfg, tstate.photons.n) == budget
    want, want_img = jpacked.interactive_frame(
        scene, jpacked.pack_state(state), scene.camera, grid, jcfg, budget,
        fresh_round=True)
    got, img = tpacked.interactive_frame(
        tscene, tpacked.pack_state(tstate), tscene.camera, tgrid, tcfg,
        budget, fresh_round=True)

    np.testing.assert_array_equal(got.misc.numpy(), np.asarray(want.misc))
    np.testing.assert_array_equal(got.key.numpy(), np.asarray(want.key))
    np.testing.assert_array_equal(got.retraced.numpy(),
                                  np.asarray(want.retraced))
    jsoa, tsoa = np.asarray(want.photon_soa), got.photon_soa.numpy()
    before = np.asarray(jpacked.pack_state(state).photon_soa)
    changed = np.any(jsoa != before, axis=(0, 2))
    agree = _lanes_agree(jsoa, tsoa)
    print(f"{int(changed.sum())} lanes retraced to new paths; "
          f"{agree[changed].mean():.4f} of them agree")
    assert changed.sum() > 20
    assert agree[changed].mean() >= MIN_LANE_FRACTION
    assert agree.mean() >= MIN_LANE_FRACTION
    lv, want_lv = got.light_volume.numpy(), np.asarray(want.light_volume)
    np.testing.assert_allclose(lv, want_lv, rtol=LV_RTOL,
                               atol=LV_ATOL_REL * np.abs(want_lv).max())
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img),
                               rtol=IMAGE_RTOL, atol=IMAGE_ATOL)


def test_no_render_and_fresh_round(shared):
    """``do_render=False`` returns the same packed state and a (0, 0, 4)
    image. Mid-drain, ``fresh_round=True`` is the frame from the state with
    an empty retraced mask and nothing remaining; without it the frame
    skips the photons already retraced."""
    _, _, _, tscene, tstate, tgrid = shared
    _, tcfg = _configs()
    budget = tstep.recompute_budget(tcfg, tstate.photons.n)
    packed = tpacked.pack_state(tstate)
    first, img = tpacked.interactive_frame(tscene, packed, tscene.camera,
                                           tgrid, tcfg, budget,
                                           fresh_round=True)
    alone, none = tpacked.interactive_frame(tscene, packed, tscene.camera,
                                            tgrid, tcfg, budget,
                                            fresh_round=True,
                                            do_render=False)
    assert none.shape == (0, 0, 4) and img.shape == (32, 32, 4)
    _state_equal(tpacked.unpack_state(alone), tpacked.unpack_state(first))

    mid = tpacked.unpack_state(first)
    assert mid.n_remaining > 0 and int(mid.retraced.sum()) == budget
    fresh, _ = tpacked.interactive_frame(tscene, first, tscene.camera, tgrid,
                                         tcfg, budget, fresh_round=True,
                                         do_render=False)
    reset = tpacked.pack_state(dataclasses.replace(
        mid, retraced=torch.zeros_like(mid.retraced), n_remaining=0))
    want, _ = tpacked.interactive_frame(tscene, reset, tscene.camera, tgrid,
                                        tcfg, budget, do_render=False)
    _state_equal(tpacked.unpack_state(fresh), tpacked.unpack_state(want))
    drained, _ = tpacked.interactive_frame(tscene, first, tscene.camera,
                                           tgrid, tcfg, budget,
                                           do_render=False)
    after = tpacked.unpack_state(drained)
    # The second batch adds its photons to the first batch's.
    assert bool((after.retraced >= mid.retraced).all())
    assert int(after.retraced.sum()) == 2 * budget
    assert after.n_remaining == mid.n_remaining - budget
    assert after.recompute_phase == mid.recompute_phase + 1

"""BASELINE config 2's and config 5's paths on the port against the JAX
reference, at a small size (CPU: a 24^3 smoke cloud, 32^2 photons a light,
4 interactions, a 64^2 image), and the port-side builders with which
chip_smoke.py drives those two configurations on the card:

- config 5's two directional lights: ``init_state``, then
  ``full_trace_step`` and ``render_state`` from the reference's own
  initial state;
- config 2's progressive refinement: four ``progressive_step`` passes from
  the reference's traced state, the running mean and the relative change
  of each pass (bench.py:309-311);
- config 5's correlated update after a TF edit: ``correlated_step_scalable``
  with two lights and 4 quadrature samples, with a trace chunk that
  divides the budget (the reference fails where it does not, ROADMAP
  queue 3);
- ``chip_smoke.build_config2`` and ``build_config5`` field by field against
  ``bench.build`` (bench.py:34-64) with the arguments of ``--config2`` and
  ``--large512``; the volume they ask for is recorded, not made.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from cpm_tpu.core import camera as jcamera
from cpm_tpu.core import lights as jlights
from cpm_tpu.core import scene as jscene
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import PipelineConfig as JPipelineConfig
from cpm_tpu.core.config import RecomputeConfig as JRecomputeConfig
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic as jsynthetic
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core.config import (PipelineConfig, RecomputeConfig,
                                       RenderConfig, TracerConfig)
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.io import synthetic as tsynthetic
from cpm_tpu_torch.pipeline import step as tstep

# A whole frame or step from the same state, light volume and image:
# relative L1 (tests/test_torch_pipeline.py, tests/test_torch_correlated.py;
# XLA and torch round log/exp differently, which flips a few lanes).
FRAME_REL_L1 = 1e-2
# Emitted light samples: float32 elementwise math in two frameworks.
EMIT_RTOL = EMIT_ATOL = 1e-6
# A pass's relative change is a difference of two running means, each
# within FRAME_REL_L1 of the reference's relative to its own sum: so the
# two changes agree within twice that, absolutely.
CHANGE_ATOL = 2 * FRAME_REL_L1
# The photons' importance, in two frameworks from the same photons
# (tests/test_torch_path_importance.py).
IMP_RTOL = IMP_ATOL = 1e-5
# The running mean against the float64 mean of the passes' light volumes:
# one float32 rounding of the mean a pass (chip_smoke.CONFIG2_ACCUM_REL_L1).
ACCUM_REL_L1 = 1e-5

PHOTONS = dict(photons_x=32, photons_y=32)
TRACER = dict(max_interactions=4, max_steps=6000)
RENDER = dict(width=64, height=64)
# 10% of 2,048 photons is 205, rounded up to a batch of 256; chunks of 128
# lanes divide it.
RECOMPUTE = dict(max_photons_fraction=0.1, importance_quadrature_samples=4)
TRACE_CHUNK = 128
PASSES = 4


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread beside JAX's pool (tests/test_torch_emission.py
    measured ~8x on this box's cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_of(tree) -> dict:
    """A reference pytree as {field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / np.abs(want).sum())


def _jscene(tf_points=None):
    return jscene.Scene.create(
        jtypes.Volume.from_data(jsynthetic.smoke_cloud(24, seed=3)),
        jtypes.TransferFunction.from_points(
            *(tf_points or jsynthetic.default_tf_points())),
        jtypes.TransferFunction.from_points(
            *jsynthetic.default_scattering_points()),
        [jlights.Light.directional(d) for d in chip_smoke.BENCH_LIGHTS],
        jcamera.Camera.create())


def _tscene(scene):
    return convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                    device="cpu")


def _configs(trace_chunk=None):
    jcfg = JPipelineConfig(
        tracer=JTracerConfig(trace_chunk=trace_chunk, **TRACER),
        recompute=JRecomputeConfig(**RECOMPUTE),
        render=JRenderConfig(**RENDER), **PHOTONS)
    tcfg = PipelineConfig(
        tracer=TracerConfig(trace_chunk=trace_chunk, **TRACER),
        recompute=RecomputeConfig(**RECOMPUTE),
        render=RenderConfig(**RENDER), **PHOTONS)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def frame():
    """The reference's two-light scene, its initial state, its state after
    a full trace and its image, and the scene carried over to the port."""
    scene = _jscene()
    jcfg, tcfg = _configs()
    state0 = jstep.init_state(scene, jcfg)
    state1 = jstep.full_trace_step(scene, state0, jcfg)
    image = np.asarray(jstep.render_state(scene, state1, jcfg))
    return scene, state0, state1, image, _tscene(scene), tcfg


def test_two_lights_emit_as_the_reference(frame):
    """``init_state`` with config 5's two directional lights: each light's
    samples under its own ``fold_in``, concatenated, equal to the
    reference's."""
    _, state0, _, _, tscene, tcfg = frame
    got = tstep.init_state(tscene, tcfg).light_samples
    want = state0.light_samples
    assert got.n == 2 * 32 * 32
    for f in ("origins", "directions", "powers", "tspan"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=EMIT_RTOL, atol=EMIT_ATOL, err_msg=f)
    d = got.directions.numpy()
    assert (d[:1024] == d[0]).all() and (d[1024:] == d[1024]).all()
    assert not np.array_equal(d[0], d[1024])


def test_two_light_frame_matches(frame):
    """``full_trace_step`` + ``render_state`` from the reference's initial
    state of two lights: light volume and image within FRAME_REL_L1."""
    _, state0, state1, image, tscene, tcfg = frame
    tstate = convert.state_from_numpy(leaves_of(state0), device="cpu")
    tstate = tstep.full_trace_step(tscene, tstate, tcfg)
    timage = tstep.render_state(tscene, tstate, tcfg).numpy()
    lv, want_lv = tstate.light_volume.numpy(), np.asarray(state1.light_volume)
    print(f"light volume rel L1 {rel_l1(lv, want_lv):.3e}, image rel L1 "
          f"{rel_l1(timage, image):.3e}")
    assert timage.shape == image.shape == (64, 64, 4)
    assert image[..., 3].max() > 0.1
    assert rel_l1(lv, want_lv) < FRAME_REL_L1
    assert rel_l1(timage, image) < FRAME_REL_L1


def test_progressive_passes_match(frame):
    """Config 2's loop, four passes from the reference's traced state: each
    pass's running mean within FRAME_REL_L1 of the reference's, its
    relative change (bench.py:309-311) within CHANGE_ATOL, the radius
    shrinking as the reference's; the port's running mean equals the
    float64 mean of its passes' light volumes within ACCUM_REL_L1."""
    scene, _, state1, _, tscene, tcfg = frame
    jcfg, _ = _configs()
    tstate = convert.state_from_numpy(leaves_of(state1), device="cpu")
    jstate = state1
    total = tstate.light_volume.double()
    jprev, tprev = np.asarray(jstate.light_volume_accum), \
        tstate.light_volume_accum
    for k in range(1, PASSES + 1):
        jstate = jstep.progressive_step(scene, jstate, jcfg)
        tstate = tstep.progressive_step(tscene, tstate, tcfg)
        jacc = np.asarray(jstate.light_volume_accum)
        tacc = tstate.light_volume_accum
        jchange = float(np.abs(jacc - jprev).sum()
                        / max(np.abs(jacc).sum(), 1e-9))
        tchange = float((tacc - tprev).abs().sum()
                        / torch.clamp(tacc.abs().sum(), min=1e-9))
        err = rel_l1(tacc.numpy(), jacc)
        print(f"pass {k}: running mean rel L1 {err:.3e}, change "
              f"{tchange:.4f} (reference {jchange:.4f})")
        assert tstate.photons.iteration == int(jstate.photons.iteration) == k
        assert tstate.photons.radius_rel == pytest.approx(
            float(jstate.photons.radius_rel), rel=1e-6)
        assert err < FRAME_REL_L1
        assert abs(tchange - jchange) <= CHANGE_ATOL
        total += tstate.light_volume.double()
        jprev, tprev = jacc, tacc
    mean = total / (PASSES + 1)
    assert float((tprev.double() - mean).abs().sum()
                 / mean.abs().sum()) < ACCUM_REL_L1


def _edited_tf():
    pos, cols = jsynthetic.default_tf_points()
    cols = np.array(cols, np.float32)
    cols[:, 3] = np.clip(cols[:, 3] * chip_smoke.OPACITY_EDIT, 0.0, 1.0)
    return np.asarray(pos, np.float32), cols


def test_two_light_correlated_step_scalable_matches(frame):
    """Config 5's correlated update at a small size: after the TF edit
    (every opacity times chip_smoke.OPACITY_EDIT), the importance grid and
    one ``correlated_step_scalable`` of 10% of the photons (4 quadrature
    samples, traced in chunks of TRACE_CHUNK lanes that divide the budget)
    from the reference's traced state of two lights: the importance grid
    and the photons' importance agree, a photon that only one package
    retraces ties with the batch's cut (at this size a plateau of equal
    importance straddles it), as many remain flagged, only retraced
    photons change, and the light volume is within FRAME_REL_L1."""
    _, _, state1, _, _, _ = frame
    scene = _jscene(_edited_tf())
    tscene = _tscene(scene)
    jcfg, tcfg = _configs(trace_chunk=TRACE_CHUNK)
    tstate = convert.state_from_numpy(leaves_of(state1), device="cpu")
    jgrid = jstep.build_importance_grid(scene, jcfg)
    tgrid = tstep.build_importance_grid(tscene, tcfg)
    np.testing.assert_allclose(tgrid.data.numpy(), np.asarray(jgrid.data),
                               rtol=1e-5, atol=1e-6)
    budget = jstep.recompute_budget(jcfg, state1.photons.n)
    assert budget == tstep.recompute_budget(tcfg, tstate.photons.n) == 256
    assert budget % TRACE_CHUNK == 0
    jimp = np.asarray(jstep.recompute_importance(
        jcfg, jgrid, state1.photons, state1.light_samples))
    timp = tstep.recompute_importance(tcfg, tgrid, tstate.photons,
                                      tstate.light_samples).numpy()
    np.testing.assert_allclose(timp, jimp, rtol=IMP_RTOL, atol=IMP_ATOL)
    want = jstep.correlated_step_scalable(scene, state1, jcfg, jgrid, budget)
    got = tstep.correlated_step_scalable(tscene, tstate, tcfg, tgrid, budget)
    retraced = got.retraced.numpy()
    # A photon only one package retraces ties with the batch's cut: its
    # importance is within the two packages' tolerance of the budget-th
    # largest.
    differ = retraced != np.asarray(want.retraced)
    cut = np.sort(jimp)[-budget]
    print(f"{int(differ.sum())} photons retraced by one package only, "
          f"importance {np.unique(jimp[differ])} against the cut {cut}")
    np.testing.assert_allclose(jimp[differ], cut, rtol=2 * IMP_RTOL,
                               atol=2 * IMP_ATOL)
    assert got.n_remaining == int(want.n_remaining) > 0
    assert retraced.sum() == budget
    changed = torch.any(got.photons.positions != tstate.photons.positions,
                        dim=2).any(dim=0).numpy()
    assert changed.sum() > 0 and not changed[~retraced].any()
    lv, want_lv = got.light_volume.numpy(), np.asarray(want.light_volume)
    moved = rel_l1(want_lv, np.asarray(state1.light_volume))
    print(f"{int(retraced.sum())} photons retraced, {int(changed.sum())} "
          f"changed; the step moved the light volume by rel L1 {moved:.3e}; "
          f"port vs reference {rel_l1(lv, want_lv):.3e}")
    assert moved > FRAME_REL_L1
    assert rel_l1(lv, want_lv) < FRAME_REL_L1


# --- the builders -------------------------------------------------------------


def _recorded_clouds(monkeypatch):
    """Make both packages' smoke_cloud record the (dim, seed) it is asked
    for and return an 8^3 cloud: the builders run without making a 512^3
    volume."""
    asked = []
    real = jsynthetic.smoke_cloud

    def cloud(dim=128, seed=0, octaves=4):
        asked.append((dim, seed, octaves))
        return real(8, seed=seed, octaves=octaves)

    monkeypatch.setattr(jsynthetic, "smoke_cloud", cloud)
    monkeypatch.setattr(tsynthetic, "smoke_cloud", cloud)
    return asked


def _fields(obj) -> dict:
    """A frozen dataclass (or a Light) as {field: plain value}, nested."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": w for k, w in _fields(v).items()})
        else:
            out[f.name] = tuple(np.ravel(v).tolist()) \
                if isinstance(v, (tuple, list, np.ndarray)) else v
    return out


@pytest.mark.parametrize("which", ["config2", "config5"])
def test_builders_equal_bench_build(which, monkeypatch):
    """chip_smoke's builder of each configuration against ``bench.build``
    with the arguments bench.py gives it (``--config2``, bench.py:299;
    ``--large512``, bench.py:488-490, with ``brick_scale=4``): every
    configuration field, each light, the transfer functions' points, the
    camera and the volume asked for."""
    asked = _recorded_clouds(monkeypatch)
    if which == "config2":
        jscene_, jcfg = bench.build(128, (512, 512), 4, width=512)
        tscene_, tcfg = chip_smoke.build_config2(device="cpu")
    else:
        jscene_, jcfg = bench.build(512, (2048, 1024), 4, width=1024,
                                    n_lights=2)
        jcfg = dataclasses.replace(jcfg, tracer=dataclasses.replace(
            jcfg.tracer, brick_scale=4))
        tscene_, tcfg = chip_smoke.build_config5(device="cpu")
    assert asked[0] == asked[1] == ((128 if which == "config2" else 512),
                                    3, 4)
    assert _fields(tcfg) == _fields(jcfg)
    assert len(tscene_.lights) == len(jscene_.lights) == (
        1 if which == "config2" else 2)
    for tl, jl in zip(tscene_.lights, jscene_.lights):
        assert _fields(tl) == _fields(jl)
    leaves = leaves_of(jscene_)
    for name, t in (("tf.positions", tscene_.tf.positions),
                    ("tf.colors", tscene_.tf.colors),
                    ("tf_scattering.positions",
                     tscene_.tf_scattering.positions),
                    ("tf_scattering.colors", tscene_.tf_scattering.colors),
                    ("camera.eye", tscene_.camera.eye),
                    ("camera.center", tscene_.camera.center),
                    ("camera.up", tscene_.camera.up),
                    ("volume.data", tscene_.volume.data)):
        np.testing.assert_array_equal(t.numpy(), leaves[name], err_msg=name)
    assert tscene_.camera.fov_y == pytest.approx(
        float(leaves["camera.fov_y"]), rel=1e-7)
    n = tcfg.photons_x * tcfg.photons_y * len(tscene_.lights)
    assert n == (262144 if which == "config2" else chip_smoke.CONFIG5_LANES)

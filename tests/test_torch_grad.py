"""Gradients through the port's render (``ops/replay.py`` -> splat ->
``ops/sweep_render.py``) against ``jax.grad`` of the reference, at the
reference tests' size (16^3 smoke cloud, 16^2 light samples, 3
interactions, an 8^3 light volume, a 12^2 image): tests/test_grad.py's
loss in all four parameter groups, on the reference's photons carried
across; the sweep alone; the port's own finite differences; the repairs
this path needed (``TransferFunction.from_points`` keeps a graph, the
trace records none); and examples/fit_tf_torch.py's first gradient
against examples/fit_tf.py's.

Tolerances: values to rtol 1e-5 and gradients to rtol 1e-4 with an
absolute floor of 1e-5 of the largest component (float32 sums in another
order); finite differences as tests/test_grad.py (rtol 5e-2, the light
radiance 1e-4); the fit's gradient to rtol 1e-4."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core.camera import Camera as JCamera
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.core.lights import Light as JLight
from cpm_tpu.core.types import TransferFunction as JTF
from cpm_tpu.core.types import Volume as JVolume
from cpm_tpu.io import synthetic
from cpm_tpu.ops import emit as jemit
from cpm_tpu.ops import replay as jreplay
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.ops import score_grad as jscore
from cpm_tpu.ops import splat as jsplat
from cpm_tpu.ops import sweep_render as jsweep
from cpm_tpu.ops import tracer as jtracer
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import RenderConfig, TracerConfig
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import replay, rng, splat, sweep_render, tracer

# Beside JAX's thread pool torch's own costs several times over.
torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
FIT_RTOL = 1e-4
REPO = Path(__file__).resolve().parent.parent

DIM = 16
LV_DIM = 8
TF_POS = np.array([0.0, 0.25, 0.6, 1.0], np.float32)
TF_COLS = np.array([[0.1, 0.2, 0.3, 0.05], [0.4, 0.5, 0.3, 0.3],
                    [0.9, 0.7, 0.5, 0.6], [1.0, 1.0, 1.0, 0.9]], np.float32)
SC_POS = np.array([0.0, 1.0], np.float32)
SC_COLS = np.array([[1.0, 1.0, 1.0, 0.7], [1.0, 1.0, 1.0, 0.9]], np.float32)
EYE = (0.45, 0.6, -1.5)
RENDER = dict(width=12, height=12, sampling_rate=1.5)
CHANNELS = np.linspace(0.5, 1.5, 3).astype(np.float32)


def _leaves(prefix, obj):
    return {f"{prefix}.{f}": np.asarray(v) for f, v in obj.__dict__.items()}


@pytest.fixture(scope="module")
def setup():
    """tests/test_grad.py's scene in both packages; the reference's
    photons and light samples carried across."""
    data = synthetic.smoke_cloud(DIM, seed=5)
    jvol = JVolume.from_data(data)
    jls = jemit.emit(JLight.directional((0.2, -1.0, 0.3)),
                     jsampling.stratified_grid_2d(16, 16))
    jph = jtracer.trace_photons(
        jvol, JTF.from_points(TF_POS, TF_COLS),
        JTF.from_points(SC_POS, SC_COLS), jls, jax.random.PRNGKey(3),
        JTracerConfig(max_interactions=3, max_steps=1500,
                      use_compaction=False))
    tph = convert.photons_from_numpy(_leaves("photons", jph), device="cpu")
    tls = convert.samples_from_numpy(_leaves("light_samples", jls),
                                     device="cpu")
    tvol = ttypes.Volume.from_data(data, device="cpu")
    return (jvol, jls, jph), (tvol, tls, tph)


def _jloss(jsetup, method):
    jvol, jls, jph = jsetup

    def loss(vol_data, tf_cols, sc_cols, light_scale):
        vol = jvol.replace(data=vol_data)
        tf = JTF.from_points(TF_POS, tf_cols)
        ph = jreplay.replay_photons(vol, tf, JTF.from_points(SC_POS, sc_cols),
                                    jph, jls.replace(
                                        powers=jls.powers * light_scale))
        lv = jsplat.splat_all(ph, (LV_DIM,) * 3, footprint=4, method=method)
        img = jsweep.sweep_render(vol, tf, lv, JCamera.create(eye=EYE),
                                  JRenderConfig(**RENDER))
        return jnp.sum(img[..., :3] * CHANNELS)

    return loss


def _tloss(tsetup, method):
    tvol, tls, tph = tsetup
    cam = Camera.create(eye=EYE, device="cpu")

    def loss(vol_data, tf_cols, sc_cols, light_scale):
        vol = dataclasses.replace(tvol, data=vol_data)
        tf = ttypes.TransferFunction.from_points(TF_POS, tf_cols,
                                                 device="cpu")
        tfs = ttypes.TransferFunction.from_points(SC_POS, sc_cols,
                                                  device="cpu")
        ph = replay.replay_photons(vol, tf, tfs, tph, dataclasses.replace(
            tls, powers=tls.powers * light_scale))
        lv = splat.splat_all(ph, (LV_DIM,) * 3, footprint=4, method=method)
        img = sweep_render.sweep_render(vol, tf, lv, cam,
                                        RenderConfig(**RENDER))
        return (img[..., :3] * torch.from_numpy(CHANNELS)).sum()

    return loss


def _args(tvol):
    return [tvol.data.numpy(), TF_COLS, SC_COLS, np.ones(3, np.float32)]


def _port_grads(loss, args):
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = loss(*xs)
    return float(out.detach()), [g.numpy() for g in
                                 torch.autograd.grad(out, xs)]


# The port's "cuda" splat (SplatProduct: the plain product splat on the
# CPU, its plain backward) against the reference's product splat.
SPLATS = {"scatter": ("scatter", "scatter"), "product": ("cuda", "matmul")}


@pytest.mark.parametrize("splat_name", sorted(SPLATS))
def test_all_four_groups_match_jax_grad(setup, splat_name):
    """Density, TF colours, scattering colours (albedo) and light radiance
    through replay -> splat -> sweep."""
    tmethod, jmethod = SPLATS[splat_name]
    jsetup, tsetup = setup
    args = _args(tsetup[0])
    jl = _jloss(jsetup, jmethod)
    want = [np.asarray(g) for g in jax.grad(jl, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in args])]
    val, got = _port_grads(_tloss(tsetup, tmethod), args)
    np.testing.assert_allclose(val, float(jl(*args)), rtol=VALUE_RTOL)
    for name, g, w in zip(("density", "tf", "albedo", "light"), got, want):
        assert np.abs(w).max() > 0.0, name
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=name)


def _direction(group, shape):
    if group == "density":
        return np.random.RandomState(0).randn(*shape)
    if group == "tf":
        return np.random.RandomState(1).rand(*shape) * 0.5 + 0.1
    v = np.zeros(shape)
    v[:, 3] = [0.7, 1.0]
    return v


@pytest.mark.parametrize("group,eps", [("density", 3e-3), ("tf", 2e-3),
                                       ("albedo", 2e-3)])
def test_port_gradient_matches_finite_differences(setup, group, eps):
    """tests/test_grad.py's directional checks on the port itself."""
    _, tsetup = setup
    argnum = ("density", "tf", "albedo").index(group)
    args = _args(tsetup[0])
    loss = _tloss(tsetup, "scatter")
    _, grads = _port_grads(loss, args)
    v = _direction(group, args[argnum].shape)
    v = (v / np.linalg.norm(v.ravel())).astype(np.float32)

    def at(sign):
        moved = [torch.from_numpy(np.array(a)) for a in args]
        moved[argnum] = moved[argnum] + sign * eps * torch.from_numpy(v)
        with torch.no_grad():
            return float(loss(*moved))

    fd = (at(1.0) - at(-1.0)) / (2 * eps)
    an = float(np.sum(grads[argnum] * v))
    assert abs(an) > 1e-8
    np.testing.assert_allclose(fd, an, rtol=5e-2)


def test_light_radiance_gradient_is_exact(setup):
    """The loss is linear in the per-channel light scale."""
    _, tsetup = setup
    args = _args(tsetup[0])
    loss = _tloss(tsetup, "cuda")
    val, grads = _port_grads(loss, args)
    for c in range(3):
        moved = [torch.from_numpy(np.array(a)) for a in args]
        moved[3][c] += 0.5
        with torch.no_grad():
            fd = (float(loss(*moved)) - val) / 0.5
        np.testing.assert_allclose(fd, grads[3][c], rtol=1e-4)


def test_sweep_render_gradients_match_jax_grad(setup):
    """The sweep alone, with respect to the light volume, the TF colours
    and the volume."""
    (jvol, _, _), (tvol, _, _) = setup
    lv = np.random.default_rng(2).uniform(0.0, 2.0, (LV_DIM,) * 3 + (3,))
    lv = lv.astype(np.float32)
    w = np.random.default_rng(3).uniform(0.5, 1.5, (12, 12, 4)).astype(
        np.float32)

    def jl(light, cols, data):
        img = jsweep.sweep_render(jvol.replace(data=data),
                                  JTF.from_points(TF_POS, cols), light,
                                  JCamera.create(eye=EYE),
                                  JRenderConfig(**RENDER))
        return jnp.sum(img * w)

    def tl(light, cols, data):
        img = sweep_render.sweep_render(
            dataclasses.replace(tvol, data=data),
            ttypes.TransferFunction.from_points(TF_POS, cols, device="cpu"),
            light, Camera.create(eye=EYE, device="cpu"),
            RenderConfig(**RENDER))
        return (img * torch.from_numpy(w)).sum()

    args = [lv, TF_COLS, tvol.data.numpy()]
    want = jax.grad(jl, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in args])
    val, got = _port_grads(tl, args)
    np.testing.assert_allclose(val, float(jl(*args)), rtol=VALUE_RTOL)
    for name, g, wg in zip(("light volume", "tf", "density"), got, want):
        wg = np.asarray(wg)
        assert np.abs(wg).max() > 0.0, name
        np.testing.assert_allclose(g, wg, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(wg).max(),
                                   err_msg=name)


def test_from_points_keeps_the_graph_of_tensors():
    """Tensor points are moved, not copied through numpy: the TF equals the
    one built from numpy, and a gradient reaches the colours."""
    cols = torch.from_numpy(TF_COLS.copy()).requires_grad_(True)
    tf = ttypes.TransferFunction.from_points(torch.from_numpy(TF_POS), cols,
                                             device="cpu")
    ref = ttypes.TransferFunction.from_points(TF_POS, TF_COLS, device="cpu")
    for f in ("positions", "colors", "lut"):
        assert torch.equal(getattr(tf, f).detach(), getattr(ref, f))
    x = torch.linspace(0.0, 1.0, 50)
    g, = torch.autograd.grad(tf.sample_opacity(x).sum() + tf.lut.sum(),
                             cols)
    assert bool((g[:, 3] != 0).all()) and bool((g[:, :3] != 0).any())
    assert tf.colors.dtype == torch.float32


def test_volume_from_data_keeps_the_graph_of_a_float32_tensor():
    data = torch.rand(4, 4, 4, requires_grad=True)
    vol = ttypes.Volume.from_data(data, device="cpu")
    g, = torch.autograd.grad(vol.data.sum(), data)
    assert torch.equal(g, torch.ones_like(data))


def test_trace_records_no_graph():
    """With TF colours that require grad the trace's outputs do not."""
    cols = torch.from_numpy(TF_COLS.copy()).requires_grad_(True)
    tf = ttypes.TransferFunction.from_points(TF_POS, cols, device="cpu")
    tfs = ttypes.TransferFunction.from_points(SC_POS, SC_COLS, device="cpu")
    vol = ttypes.Volume.from_data(synthetic.smoke_cloud(8, seed=1),
                                  device="cpu")
    ls = dataclasses.replace(
        convert.samples_from_numpy(_leaves("light_samples", jemit.emit(
            JLight.directional((0.0, -1.0, 0.0)),
            jsampling.stratified_grid_2d(8, 8))), device="cpu"))
    ph, ev = tracer.trace_photons(vol, tf, tfs, ls, rng.prng_key(0),
                                  TracerConfig(max_interactions=2),
                                  record_events=16)
    tensors = [getattr(ph, f) for f in ("positions", "powers", "directions",
                                        "exit_power", "exit_direction")]
    assert not any(t.requires_grad for t in tensors + list(ev))
    assert int((ph.positions[..., 0] < 1e30).sum()) > 0


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def test_fit_tf_first_gradient_matches_reference():
    """examples/fit_tf_torch.py's gradient at theta = 0.02 against
    examples/fit_tf.py's surrogate, on the reference's target, photons
    and tape carried across."""
    ref, port = _load("fit_tf"), _load("fit_tf_torch")
    theta = ref.THETA_INIT
    vol, tfs, ls, cam, cfg, rcfg = ref.scene()
    key = jax.random.PRNGKey(7)
    radius = jnp.float32(1.0 / 16.0)
    ph_t, _ = jtracer.trace_photons(vol, ref.tf_of(ref.THETA_TRUE), tfs, ls,
                                    key, cfg, record_events=64)
    ref._PH = ph_t.replace(radius_rel=radius)
    target = ref.render_from_deposits(ref._PH.powers, vol,
                                      ref.tf_of(ref.THETA_TRUE), cam, rcfg)
    photons, events = jtracer.trace_photons(
        vol, ref.tf_of(theta), tfs, ls, jax.random.fold_in(key, 1), cfg,
        record_events=64)
    ref._PH = photons.replace(radius_rel=radius)

    def loss_scene(dep, v, tf_, s, l):
        img = ref.render_from_deposits(dep, v, tf_, cam, rcfg)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2) * 1e3

    sur = jscore.make_surrogate(vol, ref.tf_of(theta), tfs, ls, ref._PH,
                                events, loss_scene, loss_takes_scene=True)
    want = float(jax.grad(lambda t: sur(vol, ref.tf_of(t), tfs, ls))(theta))
    want_loss = float(loss_scene(ref._PH.powers, vol, ref.tf_of(theta), tfs,
                                 ls))

    sc = port.scene("cpu")
    tph = convert.photons_from_numpy(_leaves("photons", ref._PH),
                                     device="cpu")
    tev = convert.events_from_numpy(
        {f"events.{f}": np.asarray(v) for f, v in events._asdict().items()},
        device="cpu")
    loss, got = port.theta_gradient(sc, theta, tph, tev,
                                    torch.from_numpy(np.array(target)))
    assert abs(want) > 1e3
    np.testing.assert_allclose(loss, want_loss, rtol=VALUE_RTOL)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)

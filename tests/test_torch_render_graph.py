"""The sweep render without host reads, and its CUDA graphs
(``ops/sweep_render.py``, ``core/camera.py``). Imports no JAX, so that the
card tests run where JAX is not installed (``--noconftest``).

On the CPU:

- ``Camera.create`` keeps host copies equal to its device fields bit for
  bit, and its fov on the device; a camera whose fields were replaced or
  changed in place reads the card again;
- the plane schedule's reference plane, now taken on the device, equals
  the index by a device scalar that it replaces, for eyes on every axis,
  both signs and inside the volume;
- a render records no ``wait.camera.host``, ``wait.render.z_base`` or
  ``wait.camera.fov`` under a profiler, and no graph counter;
- the image, with the intermediate asked for or not, is that of the
  benchmark's frozen plain form of the renderer
  (``cpmbench/reference/sweep_render.py``) bit for bit, and an eye inside
  the volume still has no single intermediate.

On the card (marked ``cuda``): over two laps of an orbit of 12 cameras that
turns the marching axis between x and z in both signs, with new TF values
and light volumes at every render, every replayed image equals the eager
render of the same inputs bit for bit, and the counters read one eager
render, one capture and the rest replays a key; an image held is not
overwritten by the next render; a replay counts the eager render's kernel
launches; a TF that requires grad renders eagerly with the gradients of a
render without graphs; an eye inside the volume (two sweeps) replays bit
for bit; at most ``RENDER_GRAPHS`` graphs are kept.
"""

import collections
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import RenderConfig
from cpm_tpu_torch.io import synthetic
from cpm_tpu_torch.ops import sweep_render as sw

DIM, LV_DIM = 24, 9
RENDER = dict(width=40, height=32, sampling_rate=1.5)
CENTER = (0.5, 0.5, 0.5)
# (eye, center): outside on each axis and sign, and two inside the slab
# range of their marching axis.
EYES = {
    "-z": ((0.45, 0.6, -1.5), CENTER),
    "+z": ((0.55, 0.4, 2.2), CENTER),
    "-x": ((-1.7, 0.4, 0.6), CENTER),
    "+x": ((2.0, 0.4, 0.5), CENTER),
    "-y": ((0.4, -1.7, 0.6), CENTER),
    "+y": ((0.6, 2.1, 0.45), CENTER),
    "inside z": ((0.5, 0.55, 0.3), (0.5, 0.5, 0.9)),
    "inside x": ((0.7, 0.45, 0.5), (0.1, 0.5, 0.55)),
}
WAITS = ("wait.camera.host", "wait.render.z_base", "wait.camera.fov")
GRAPH_COUNTERS = ("render.graph_eager", "render.graph_captures",
                  "render.graph_replays")


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    telemetry.reset()
    sw.clear_render_graphs()
    yield
    telemetry.reset()
    sw.clear_render_graphs()


def _inputs(device, seed=0, tf_scale=1.0):
    """The volume, a TF (its opacities times ``tf_scale``) and a light
    volume drawn from ``seed``."""
    vol = ttypes.Volume.from_data(synthetic.smoke_cloud(DIM, seed=3),
                                  device=device)
    pos, col = synthetic.default_tf_points()
    col = np.array(col, np.float32)
    col[:, 3] *= tf_scale
    tf = ttypes.TransferFunction.from_points(pos, col, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    lv = torch.rand((LV_DIM,) * 3 + (3,), generator=g, device=device)
    return vol, tf, lv


def _camera(case, device):
    eye, center = EYES[case]
    return Camera.create(eye=eye, center=center, device=device)


# --- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("eye", [(0.45, 0.6, -1.5), (0.1, 0.7, 1.3),
                                 (1e-7, -2.3, 0.333333)])
def test_create_keeps_host_copies_equal_to_its_device_fields(eye):
    cam = Camera.create(eye=eye, up=(0.0, 1.0, 0.1), fov_y=37.3,
                        device="cpu")
    for name in ("eye", "center", "up"):
        host = cam.host(name)
        assert host.dtype == np.float32
        assert np.array_equal(host.view(np.uint32),
                              getattr(cam, name).numpy().view(np.uint32))
    fov = cam.fov()
    assert fov.dtype == torch.float32 and fov.shape == ()
    assert fov.item() == cam.fov_y == float(np.float32(37.3))
    # What host() gives is the caller's to change.
    cam.host("eye")[0] = 9.0
    assert cam.host("eye")[0] == np.float32(eye[0])


def test_a_changed_camera_reads_its_fields_again():
    cam = Camera.create(device="cpu")
    moved = dataclasses.replace(cam, eye=torch.tensor([0.2, 0.3, 2.0]))
    widened = dataclasses.replace(cam, fov_y=60.0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert cam.host("eye").tolist() == pytest.approx([0.5, 0.5, -1.5])
        assert telemetry.snapshot()["counters"] == {}
        assert moved.host("eye").tolist() == pytest.approx([0.2, 0.3, 2.0])
        assert widened.fov().item() == 60.0
        cam.center.add_(0.25)
        assert cam.host("center").tolist() == pytest.approx([0.75] * 3)
        counters = telemetry.snapshot()["counters"]
    assert counters == {"wait.camera.host": 2, "wait.camera.fov": 1}
    # Built without create: every read goes to the card, as before.
    bare = Camera(eye=cam.eye, center=cam.center, up=cam.up, fov_y=45.0)
    assert bare.made is None
    assert np.array_equal(bare.host("up"), cam.up.numpy())


@pytest.mark.parametrize("case", list(EYES))
def test_z_base_on_the_device_equals_the_index_by_a_device_scalar(case):
    cam = _camera(case, "cpu")
    shape = sw._sweep_shape((DIM,) * 3, cam, RenderConfig(**RENDER))
    assert len(shape.signs) == (2 if case.startswith("inside") else 1)
    for sign in shape.signs:
        sched = sw._plane_schedule(cam, shape.axis, sign, shape.n_planes,
                                   RENDER["width"], RENDER["height"])
        za, o_a = sched.za, cam.eye[shape.axis]
        k0 = torch.argmax(((za - o_a) * float(sign) > 1e-6).to(torch.int32))
        want = za[k0]
        assert sched.z_base.shape == want.shape == ()
        assert torch.equal(sched.z_base, want)


@pytest.mark.parametrize("case", ["-z", "+x", "inside z"])
def test_a_render_reads_nothing_back_from_the_card(case):
    vol, tf, lv = _inputs("cpu")
    cam = _camera(case, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        sw.sweep_render(vol, tf, lv, cam, RenderConfig(**RENDER))
        snap = telemetry.snapshot()
    names = {s[0] for s in snap["spans"]}
    assert "render.sweep" in names
    assert not set(WAITS) & (names | set(snap["counters"]))
    # The CPU renders eagerly and counts no graph.
    assert not set(GRAPH_COUNTERS) & set(snap["counters"])
    assert not sw._graphs


@pytest.mark.parametrize("case", ["-z", "+z", "-x", "+y", "inside z",
                                  "inside x"])
def test_the_cpu_image_is_the_frozen_plain_forms(case):
    from cpmbench.reference import camera as rcamera
    from cpmbench.reference import config as rconfig
    from cpmbench.reference import sweep_render as rsw
    from cpmbench.reference import types as rtypes
    vol, tf, lv = _inputs("cpu", seed=7)
    eye, center = EYES[case]
    got = sw.sweep_render(vol, tf, lv, _camera(case, "cpu"),
                          RenderConfig(**RENDER))
    pos, col = synthetic.default_tf_points()
    want = rsw.sweep_render(
        rtypes.Volume.from_data(synthetic.smoke_cloud(DIM, seed=3),
                                device="cpu"),
        rtypes.TransferFunction.from_points(pos, col, device="cpu"), lv,
        rcamera.Camera.create(eye=eye, center=center, device="cpu"),
        rconfig.RenderConfig(**RENDER))
    assert torch.equal(got, want)
    if not case.startswith("inside"):
        img, inter, ranges = sw.sweep_render(
            vol, tf, lv, _camera(case, "cpu"), RenderConfig(**RENDER),
            return_intermediate=True)
        assert torch.equal(img, want)
        assert inter.shape == (128, 128, 4) and len(ranges) == 5


def test_an_eye_inside_has_no_single_intermediate():
    vol, tf, lv = _inputs("cpu")
    with pytest.raises(ValueError, match="inside the volume slab range"):
        sw.sweep_render(vol, tf, lv, _camera("inside z", "cpu"),
                        RenderConfig(**RENDER), return_intermediate=True)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counters():
    c = telemetry.snapshot()["counters"]
    return tuple(c.get(name, 0) for name in GRAPH_COUNTERS)


def _eager(*args, **kwargs):
    """The render with every graph forgotten: an eager one."""
    sw.clear_render_graphs()
    out = sw.sweep_render(*args, **kwargs)
    sw.clear_render_graphs()
    return out


def _orbit(i: int, device):
    """The i-th camera of an orbit of radius 2 about the centre, 30 degrees
    a step from azimuth 10, elevation swinging within 25 degrees."""
    az = math.radians(10 + 30 * i)
    el = math.radians(25 * math.sin(i))
    eye = (0.5 + 2 * math.cos(el) * math.sin(az), 0.5 + 2 * math.sin(el),
           0.5 - 2 * math.cos(el) * math.cos(az))
    return Camera.create(eye=eye, center=CENTER, fov_y=40.0 + i,
                         device=device)


@pytest.mark.cuda
def test_an_orbit_replays_the_eager_images_bit_for_bit(card):
    rc = RenderConfig(**RENDER)
    renders, keys = [], collections.Counter()
    for i in range(24):
        cam = _orbit(i % 12, card)
        vol, tf, lv = _inputs(card, seed=i, tf_scale=1.0 + 0.05 * i)
        shape = sw._sweep_shape(vol.data.shape, cam, rc)
        keys[(shape.axis, shape.signs)] += 1
        renders.append(((vol, tf, lv, cam), sw.sweep_render(vol, tf, lv, cam,
                                                             rc)))
    torch.cuda.synchronize()
    assert {k[0] for k in keys} == {0, 2}
    assert {k[1] for k in keys} == {(1,), (-1,)}
    assert min(keys.values()) >= 3
    n = len(keys)
    assert _counters() == (n, n, 24 - 2 * n)
    for i, (args, img) in enumerate(renders):
        assert torch.equal(img, _eager(*args, rc)), i


@pytest.mark.cuda
def test_an_image_held_is_not_overwritten_by_the_next_render(card):
    rc = RenderConfig(**RENDER)
    cam = _camera("-z", card)
    held, copies = [], []
    for i in range(5):
        vol, tf, lv = _inputs(card, seed=i, tf_scale=1.0 + 0.1 * i)
        held.append(sw.sweep_render(vol, tf, lv, cam, rc))
        copies.append(held[-1].clone())
    torch.cuda.synchronize()
    assert _counters() == (1, 1, 3)
    for img, copy in zip(held, copies):
        assert torch.equal(img, copy)
    assert len({img.data_ptr() for img in held}) == 5
    assert not torch.equal(held[3], held[4])
    # The intermediate and the ranges are the caller's too.
    vol, tf, lv = _inputs(card, seed=9)
    outs = [sw.sweep_render(vol, tf, lv, cam, rc, return_intermediate=True)
            for _ in range(3)]
    assert outs[2][1].data_ptr() != outs[1][1].data_ptr()
    assert outs[2][2][4].data_ptr() != outs[1][2][4].data_ptr()
    for a, b in zip(outs[1][2], outs[2][2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["-x", "inside z"])
def test_a_replay_counts_the_eager_renders_launches(card, case):
    rc = RenderConfig(**RENDER)
    vol, tf, lv = _inputs(card)
    cam = _camera(case, card)
    sweeps = 2 if case.startswith("inside") else 1
    for _ in range(3):
        before = telemetry.launch_counts()
        sw.sweep_render(vol, tf, lv, cam, rc)
        after = telemetry.launch_counts()
        made = {k: n - before.get(k, 0) for k, n in after.items()
                if n != before.get(k, 0)}
        assert made == {"sweep_planes": sweeps,
                        "sweep_scan_forward": sweeps}
    assert _counters() == (1, 1, 1)


@pytest.mark.cuda
def test_a_tf_that_requires_grad_stays_eager(card):
    rc = RenderConfig(**RENDER)
    vol, tf, lv = _inputs(card)
    cam = _camera("+x", card)
    for _ in range(3):  # a graph of this key, replayed
        plain = sw.sweep_render(vol, tf, lv, cam, rc)
    assert _counters() == (1, 1, 1)

    def grads():
        pos = tf.positions.clone().requires_grad_(True)
        col = tf.colors.clone().requires_grad_(True)
        leaf = dataclasses.replace(tf, positions=pos, colors=col)
        img = sw.sweep_render(vol, leaf, lv, cam, rc)
        (img * torch.linspace(0.5, 1.5, img.numel(), device=card).view(
            img.shape)).sum().backward()
        return img.detach(), pos.grad, col.grad

    img, g_pos, g_col = grads()
    assert _counters() == (2, 1, 1)
    assert torch.equal(img, plain)
    sw.clear_render_graphs()
    _, want_pos, want_col = grads()
    assert _counters() == (3, 1, 1)
    # The backward's atomics sum in another order from run to run.
    for got, want in ((g_pos, want_pos), (g_col, want_col)):
        torch.testing.assert_close(
            got, want, rtol=1e-3, atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_an_eye_inside_replays_bit_for_bit(card):
    rc = RenderConfig(**RENDER)
    cam = _camera("inside x", card)
    got = []
    for i in range(4):
        vol, tf, lv = _inputs(card, seed=20 + i, tf_scale=0.8 + 0.1 * i)
        got.append(((vol, tf, lv), sw.sweep_render(vol, tf, lv, cam, rc)))
    assert _counters() == (1, 1, 2)
    for (vol, tf, lv), img in got:
        assert torch.equal(img, _eager(vol, tf, lv, cam, rc))


@pytest.mark.cuda
def test_at_most_render_graphs_are_kept(card):
    vol, tf, lv = _inputs(card)
    cam = _camera("-z", card)
    n = sw.RENDER_GRAPHS + 2
    for width in range(16, 16 + n):
        rc = RenderConfig(width=width, height=24)
        for _ in range(2):
            sw.sweep_render(vol, tf, lv, cam, rc)
    assert len(sw._graphs) == sw.RENDER_GRAPHS
    assert _counters() == (n, n, 0)
    # The oldest keys went first: the first width renders eagerly again.
    sw.sweep_render(vol, tf, lv, cam, RenderConfig(width=16, height=24))
    assert _counters() == (n + 1, n, 0)

"""The port's shear-warp sweep renderer against the JAX reference at
24^2 pixels over a 16^3 volume, for cameras along each axis and for an eye
inside the volume (the two-pass render)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import camera as jcamera
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import sweep_render as jsw
from cpm_tpu_torch.core import camera as tcamera
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import RenderConfig
from cpm_tpu_torch.ops import sweep_render as tsw

# Images and intermediates: float32 compositing over 32 planes; the
# reference's bf16x3 products are fp32-accurate, the port's are fp32.
ATOL = 1e-5

OUTSIDE_EYES = [(0.45, 0.6, -1.5), (0.5, 0.4, 2.3), (2.0, 0.4, 0.5),
                (0.3, 2.2, 0.6), (-1.2, 0.7, 0.35)]


@pytest.fixture(scope="module")
def scene():
    data = synthetic.smoke_cloud(16, seed=4)
    tf = synthetic.default_tf_points()
    lv = np.random.default_rng(8).random((8, 8, 8, 3)).astype(np.float32)
    lv *= 0.4
    return ((jtypes.Volume.from_data(data),
             jtypes.TransferFunction.from_points(*tf), jnp.asarray(lv)),
            (ttypes.Volume.from_data(data, device="cpu"),
             ttypes.TransferFunction.from_points(*tf, device="cpu"),
             torch.from_numpy(lv)))


def _cameras(eye, center=(0.5, 0.5, 0.5)):
    return (jcamera.Camera.create(eye=eye, center=center),
            tcamera.Camera.create(eye=eye, center=center, device="cpu"))


@pytest.mark.parametrize("eye", OUTSIDE_EYES)
def test_sweep_core_matches(scene, eye):
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    jcam, tcam = _cameras(eye)
    axis, sign = tsw.principal_axis(tcam)
    assert (axis, sign) == jsw.principal_axis(jcam)
    kw = dict(axis=axis, sign=sign, n_planes=32, inter_u=40, inter_v=36,
              width=24, height=24, ambient=0.05)
    jimg, jinter, jgrid = jsw._sweep_core(jvol.data, jtf, jlv, jcam, **kw)
    timg, tinter, tgrid = tsw._sweep_core(tvol.data, ttf, tlv, tcam, **kw)
    assert float(np.asarray(jimg)[..., 3].max()) > 0.05
    np.testing.assert_allclose(tinter.numpy(), np.asarray(jinter), atol=ATOL)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=ATOL)
    for t, j in zip(tgrid, jgrid):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("eye,center", [
    ((0.5, 0.55, 0.3), (0.5, 0.5, 0.9)),
    ((0.6, 0.5, 0.5), (0.1, 0.45, 0.55))])
def test_sweep_render_eye_inside_the_volume(scene, eye, center):
    """Two sweeps, one per marching sign, summed."""
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    jcam, tcam = _cameras(eye, center)
    cfg = dict(width=24, height=24, sampling_rate=2.0)
    want = jsw.sweep_render(jvol, jtf, jlv, jcam, JRenderConfig(**cfg))
    got = tsw.sweep_render(tvol, ttf, tlv, tcam, RenderConfig(**cfg))
    assert float(np.asarray(want)[..., 3].max()) > 0.05
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError):
        tsw.sweep_render(tvol, ttf, tlv, tcam, RenderConfig(**cfg),
                         return_intermediate=True)


def test_sweep_render_default_intermediate_matches(scene):
    """The public entry point with its 128-multiple intermediate image."""
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    jcam, tcam = _cameras((0.45, 0.6, -1.5))
    cfg = dict(width=24, height=20, sampling_rate=1.0)
    jimg, jinter, _ = jsw.sweep_render(jvol, jtf, jlv, jcam,
                                       JRenderConfig(**cfg),
                                       return_intermediate=True)
    timg, tinter, _ = tsw.sweep_render(tvol, ttf, tlv, tcam,
                                       RenderConfig(**cfg),
                                       return_intermediate=True)
    assert tinter.shape == jinter.shape == (128, 128, 4)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=ATOL)


def test_hat_matrix_matches():
    x = np.random.default_rng(1).uniform(-0.2, 1.2, 57).astype(np.float32)
    for n in (1, 7, 16):
        np.testing.assert_allclose(
            tsw._hat_matrix(torch.from_numpy(x), n).numpy(),
            np.asarray(jsw._hat_matrix(jnp.asarray(x), n)), atol=1e-6)


def test_the_eye_inside_at_12_pixels_differs_in_one_edge_row(scene):
    """The reference's last-bit hazard, pinned (not a tolerance): at 12^2
    the +1 sweep's outermost rays land on the intermediate image's edge,
    and whether the edge test ``fj > -0.5`` of ``_warp`` draws the image's
    last row hangs on the last bit of ``o + t * d``, which the port rounds
    once (a float64 fused multiply-add) and the reference's compiled
    program rounds otherwise. The intermediate images agree within ATOL;
    the images agree everywhere but that row, which the port draws and the
    reference leaves empty."""
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    jcam, tcam = _cameras((0.5, 0.55, 0.3), (0.5, 0.5, 0.9))
    axis, _ = tsw.principal_axis(tcam)
    kw = dict(axis=axis, n_planes=32, inter_u=128, inter_v=128, width=12,
              height=12, ambient=0.05)
    imgs = {"port": 0.0, "reference": 0.0}
    for sign in (1, -1):
        jimg, jinter, _ = jsw._sweep_core(jvol.data, jtf, jlv, jcam,
                                          sign=sign, **kw)
        timg, tinter, _ = tsw._sweep_core(tvol.data, ttf, tlv, tcam,
                                          sign=sign, **kw)
        np.testing.assert_allclose(tinter.numpy(), np.asarray(jinter),
                                   atol=ATOL)
        imgs["port"] = imgs["port"] + timg.numpy()
        imgs["reference"] = imgs["reference"] + np.asarray(jimg)
    cfg = dict(width=12, height=12, sampling_rate=2.0)
    got = tsw.sweep_render(tvol, ttf, tlv, tcam, RenderConfig(**cfg)).numpy()
    want = np.asarray(jsw.sweep_render(jvol, jtf, jlv, jcam,
                                       JRenderConfig(**cfg)))
    np.testing.assert_allclose(got, imgs["port"], atol=ATOL)
    np.testing.assert_allclose(want, imgs["reference"], atol=ATOL)
    np.testing.assert_allclose(got[:-1], want[:-1], atol=ATOL)
    assert float(want[:-1, :, 3].max()) > 0.05
    assert not want[-1].any()
    assert (got[-1, :, 3] > 0.0).sum() == 11

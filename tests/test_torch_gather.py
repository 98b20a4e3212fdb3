"""The port's gather marcher (``ops/gather.py``), the channel trilinear
fetch and the sweep's z-plane oracle against the JAX reference, the
sweep's intermediate image against the port's own oracle
(tests/test_sweep.py:59-72), ``render_state(method="march")`` and the
eye-inside camera (tests/test_sweep.py:134-148); CPU, a 32^3 cloud and a
16^3 light volume, 24^2-48^2 pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.core import camera as jcamera
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import gather as jgather
from cpm_tpu.ops import sampling as jsampling
from cpm_tpu.ops import sweep_render as jsw
from cpm_tpu_torch.core import camera as tcamera
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import RenderConfig
from cpm_tpu_torch.ops import gather, sampling
from cpm_tpu_torch.ops import sweep_render as tsw

torch.set_num_threads(1)

# Port against reference, the same float32 math in two frameworks:
# gathers, exp and sums rounded apart.
ATOL = 2e-6
# The dense form against the loop form: the exclusive cumulative sum of
# tau against the running product of exp(-tau).
DENSE_RTOL, DENSE_ATOL = 1e-4, 1e-6
# The sweep's intermediate image against its oracle (tests/test_sweep.py:
# 71-72).
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 5e-5
# The eye inside the volume: sweep (two passes) against the marcher at 512
# steps (tests/test_sweep.py:143-148).
INSIDE_MEAN, INSIDE_CORR, INSIDE_RIM = 0.02, 0.98, 4

CAMS = [dict(eye=(0.4, 0.6, -1.4)), dict(eye=(0.5, 0.5, 2.5)),
        dict(eye=(-1.6, 0.4, 0.6)), dict(eye=(2.2, 0.7, 0.3)),
        dict(eye=(0.3, -1.8, 0.5)),
        dict(eye=(0.6, 2.1, 0.4), up=(0.0, 0.0, 1.0))]


@pytest.fixture(scope="module")
def scene():
    data = synthetic.smoke_cloud(32, seed=3)
    tf = synthetic.default_tf_points()
    lv = np.random.default_rng(7).random((16, 16, 16, 3)).astype(np.float32)
    lv *= 0.4
    return ((jtypes.Volume.from_data(data),
             jtypes.TransferFunction.from_points(*tf), jnp.asarray(lv)),
            (ttypes.Volume.from_data(data, device="cpu"),
             ttypes.TransferFunction.from_points(*tf, device="cpu"),
             torch.from_numpy(lv)))


def _cams(kw):
    return (jcamera.Camera.create(**kw),
            tcamera.Camera.create(device="cpu", **kw))


def _rays(tcam, w, h):
    o, d = tcam.rays(w, h)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def test_trilinear_vec_matches():
    rs = np.random.default_rng(2)
    data = rs.random((5, 7, 9, 3)).astype(np.float32)
    pos = rs.uniform(-0.1, 1.1, (3, 41, 3)).astype(np.float32)
    want = np.asarray(jsampling.sample_volume_trilinear_vec(
        jnp.asarray(data), jnp.asarray(pos)))
    got = sampling.sample_volume_trilinear_vec(torch.from_numpy(data),
                                               torch.from_numpy(pos))
    assert got.shape == (3, 41, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # Each channel is the scalar fetch of that channel.
    for c in range(3):
        np.testing.assert_array_equal(
            got[..., c].numpy(), sampling.sample_volume_trilinear(
                torch.from_numpy(data[..., c].copy()),
                torch.from_numpy(pos)).numpy())


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_render_matches(scene, cam):
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    jcam, tcam = _cams(CAMS[cam])
    cfg = dict(width=24, height=20, sampling_rate=1.5)
    want = np.asarray(jgather.render(jvol, jtf, jlv, jcam,
                                     JRenderConfig(**cfg)))
    got = gather.render(tvol, ttf, tlv, tcam, RenderConfig(**cfg))
    assert got.shape == (20, 24, 4)
    assert want[..., 3].max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_render_rays_chunks_loop_and_reference(scene):
    """One ray's result does not depend on the chunking (bit for bit);
    the dense form matches the loop form and both match the reference's."""
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    _, tcam = _cams(CAMS[0])
    o, d = _rays(tcam, 24, 24)
    n = 60
    dense = gather.render_rays(tvol, ttf, tlv, o, d, n)
    for chunk in (100, 576, 4096):
        assert torch.equal(gather.render_rays(tvol, ttf, tlv, o, d, n,
                                              chunk=chunk), dense)
    loop = gather.render_rays_loop(tvol, ttf, tlv, o, d, n)
    np.testing.assert_allclose(dense.numpy(), loop.numpy(), rtol=DENSE_RTOL,
                               atol=DENSE_ATOL)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jgather.render_rays(
            jvol, jtf, jlv, jo, jd, n, chunk=100)), atol=ATOL)
    np.testing.assert_allclose(
        loop.numpy(), np.asarray(jgather.render_rays_loop(
            jvol, jtf, jlv, jo, jd, n)), atol=ATOL)
    assert float(dense[:, 3].max()) > 0.1
    assert gather.chunk_size(222) == (1 << 23) // 222
    assert gather.chunk_size(1 << 20) == 1024


def test_transmittance_to_point_matches(scene):
    (jvol, jtf, _), (tvol, ttf, _) = scene
    rs = np.random.default_rng(5)
    a = rs.random((64, 3)).astype(np.float32)
    b = rs.random((64, 3)).astype(np.float32)
    want = np.asarray(jgather.transmittance_to_point(
        jvol, jtf, jnp.asarray(a), jnp.asarray(b), n_steps=48))
    got = gather.transmittance_to_point(tvol, ttf, torch.from_numpy(a),
                                        torch.from_numpy(b), n_steps=48)
    assert 0.0 < want.min() and want.max() <= 1.0 and want.min() < 0.9
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _intermediate_rays(cam, inter, grid, axis):
    """tests/test_sweep.py:35-49: the rays through the intermediate image's
    pixel centres on the first plane."""
    u_lo, u_hi, v_lo, v_hi, za = (x.numpy() for x in grid)
    V, U = inter.shape[:2]
    u = u_lo + (np.arange(U, dtype=np.float32) + 0.5) / U * (u_hi - u_lo)
    v = v_lo + (np.arange(V, dtype=np.float32) + 0.5) / V * (v_hi - v_lo)
    b_axis, c_axis = [i for i in range(3) if i != axis]
    P = np.zeros((V, U, 3), np.float32)
    P[..., axis] = za[0]
    P[..., b_axis] = u[None, :]
    P[..., c_axis] = v[:, None]
    o = np.broadcast_to(cam.host("eye"), P.shape).reshape(-1, 3).astype(
        np.float32)
    return o, P.reshape(-1, 3) - o, za


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_sweep_intermediate_equals_the_ports_oracle(scene, cam):
    """The port's composited intermediate image equals the port's per-ray
    march over the same planes (tests/test_sweep.py:59-72)."""
    _, (tvol, ttf, tlv) = scene
    _, tcam = _cams(CAMS[cam])
    cfg = RenderConfig(width=48, height=48, sampling_rate=1.5)
    _, inter, grid = tsw.sweep_render(tvol, ttf, tlv, tcam, cfg,
                                      return_intermediate=True)
    axis, _ = tsw.principal_axis(tcam)
    o, d, za = _intermediate_rays(tcam, inter, grid, axis)
    oracle = tsw.march_zplanes_oracle(
        tvol, ttf, tlv, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(za), axis, cfg.ambient).reshape(inter.shape)
    assert float(oracle[..., 3].max()) > 0.1
    np.testing.assert_allclose(inter.numpy(), oracle.numpy(),
                               rtol=ORACLE_RTOL, atol=ORACLE_ATOL)


def test_march_zplanes_oracle_matches_reference(scene):
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    _, tcam = _cams(CAMS[2])
    axis, sign = tsw.principal_axis(tcam)
    o, d = _rays(tcam, 20, 20)
    za = ((np.arange(40, dtype=np.float32) + 0.5) / 40)[::sign].copy()
    want = np.asarray(jsw.march_zplanes_oracle(
        jvol, jtf, jlv, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(za), axis, 0.05))
    got = tsw.march_zplanes_oracle(tvol, ttf, tlv, o, d,
                                   torch.from_numpy(za), axis, 0.05)
    assert want[:, 3].max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_render_state_march_matches_reference():
    """render_state with render.method="march" from the same scene and
    light volume as the reference's."""
    from cpm_tpu.core import lights as jlights
    from cpm_tpu.core import scene as jscene
    from cpm_tpu.core.config import PipelineConfig as JPipelineConfig
    from cpm_tpu.pipeline import step as jstep
    from cpm_tpu_torch.core.config import PipelineConfig
    from cpm_tpu_torch.io import convert
    from cpm_tpu_torch.pipeline import step as tstep
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.smoke_cloud(16, seed=6)),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create(eye=(0.45, 0.6, -1.5)))
    render = dict(width=24, height=24, sampling_rate=2.0, method="march")
    jcfg = JPipelineConfig(render=JRenderConfig(**render), photons_x=4,
                           photons_y=4)
    tcfg = PipelineConfig(render=RenderConfig(**render), photons_x=4,
                          photons_y=4)
    lv = np.random.default_rng(3).random((65, 65, 65, 3)).astype(np.float32)
    state = jstep.init_state(scene, jcfg).replace(
        light_volume_accum=jnp.asarray(lv))
    want = np.asarray(jstep.render_state(scene, state, jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    leaves = {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                       for k in path): np.asarray(leaf)
              for path, leaf in flat}
    tscene = convert.scene_from_numpy(leaves, scene.lights, device="cpu")
    tstate = tstep.init_state(tscene, tcfg)
    tstate.light_volume_accum = torch.from_numpy(lv)
    got = tstep.render_state(tscene, tstate, tcfg)
    assert got.shape == (24, 24, 4) and want[..., 3].max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    with pytest.raises(ValueError, match="render method"):
        tstep.render_state(tscene, tstate, PipelineConfig(
            render=RenderConfig(method="splat")))


def test_eye_inside_sweep_matches_the_marcher(scene):
    """tests/test_sweep.py:134-148 on the port: the two-pass sweep against
    the marcher at 512 steps, and the port's marcher against the
    reference's there."""
    (jvol, jtf, jlv), (tvol, ttf, tlv) = scene
    kw = dict(eye=(0.5, 0.5, 0.45), center=(0.5, 0.5, 2.0))
    jcam, tcam = _cams(kw)
    cfg = dict(width=32, height=32, sampling_rate=4.0)
    img = tsw.sweep_render(tvol, ttf, tlv, tcam, RenderConfig(**cfg)).numpy()
    ref = gather.render(tvol, ttf, tlv, tcam, RenderConfig(**cfg),
                        n_steps=512).numpy()
    assert float(img[..., 3].sum()) > 0.0
    c = INSIDE_RIM
    diff = np.abs(img[c:-c, c:-c] - ref[c:-c, c:-c])
    assert float(diff.mean()) < INSIDE_MEAN, float(diff.mean())
    assert np.corrcoef(img[c:-c, c:-c, :3].ravel(),
                       ref[c:-c, c:-c, :3].ravel())[0, 1] > INSIDE_CORR
    want = np.asarray(jgather.render(jvol, jtf, jlv, jcam,
                                     JRenderConfig(**cfg), n_steps=512))
    np.testing.assert_allclose(ref, want, atol=ATOL)

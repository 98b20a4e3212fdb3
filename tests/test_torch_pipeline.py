"""The port's forward frame (init_state -> full_trace_step -> render_state)
against the JAX reference from the same converted state, the port's
radial splat + sweep against the float64 oracle, the state conversion,
and a run of the port with JAX and the reference package made
unimportable (CPU, 16^3 volume, 32^2 photons)."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from cpm_tpu.core import camera as jcamera
from cpm_tpu.core import constants
from cpm_tpu.core import lights as jlights
from cpm_tpu.core import scene as jscene
from cpm_tpu.core import types as jtypes
from cpm_tpu.core.config import PipelineConfig as JPipelineConfig
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic
from cpm_tpu.oracle import reference as oracle
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                       TracerConfig)
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import splat as tsplat
from cpm_tpu_torch.ops import sweep_render as tsw
from cpm_tpu_torch.pipeline import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Whole frame from the same state: relative L1 of light volume and image.
FRAME_REL_L1 = 1e-2
# Emitted light samples: float32 elementwise math in two frameworks.
EMIT_RTOL = EMIT_ATOL = 1e-6
# Radial splat vs the float64 oracle, and the image vs the float64 DVR
# oracle (tests/test_golden_image.py).
RADIAL_RTOL, RADIAL_ATOL = 1e-4, 1e-6
IMAGE_MAX_ERR, IMAGE_MEAN_ERR = 2e-3, 5e-5

TRACER = dict(max_interactions=2, max_steps=2000)
RENDER = dict(width=24, height=24, sampling_rate=2.0)
PHOTONS = dict(photons_x=32, photons_y=32)
EYE = (0.45, 0.6, -1.5)


def leaves_of(tree) -> dict:
    """A reference pytree as {field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / np.abs(want).sum())


@pytest.fixture(scope="module")
def frame():
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.smoke_cloud(16, seed=6)),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create(eye=EYE))
    jcfg = JPipelineConfig(tracer=JTracerConfig(**TRACER),
                           render=JRenderConfig(**RENDER), **PHOTONS)
    tcfg = PipelineConfig(tracer=TracerConfig(**TRACER),
                          render=RenderConfig(**RENDER), **PHOTONS)
    state0 = jstep.init_state(scene, jcfg)
    state1 = jstep.full_trace_step(scene, state0, jcfg)
    image = np.asarray(jstep.render_state(scene, state1, jcfg))
    tscene = convert.scene_from_numpy(leaves_of(scene), scene.lights,
                                      device="cpu")
    return scene, state0, state1, image, tscene, tcfg


def test_init_state_matches(frame):
    scene, state0, _, _, tscene, tcfg = frame
    want = leaves_of(state0)
    got = convert.state_to_numpy(tstep.init_state(tscene, tcfg))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=EMIT_RTOL, atol=EMIT_ATOL,
                                   err_msg=k)


def test_state_round_trip(frame):
    _, _, state1, _, _, _ = frame
    leaves = leaves_of(state1)
    back = convert.state_to_numpy(
        convert.state_from_numpy(leaves, device="cpu"))
    assert sorted(back) == sorted(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_full_frame_matches(frame):
    """full_trace_step + render_state from the reference's own initial
    state: light volume and image within 1% relative L1."""
    _, state0, state1, image, tscene, tcfg = frame
    tstate = convert.state_from_numpy(leaves_of(state0), device="cpu")
    tstate = tstep.full_trace_step(tscene, tstate, tcfg)
    timage = tstep.render_state(tscene, tstate, tcfg).numpy()
    lv, want_lv = tstate.light_volume.numpy(), np.asarray(state1.light_volume)
    print(f"light volume rel L1 {rel_l1(lv, want_lv):.3e}, image rel L1 "
          f"{rel_l1(timage, image):.3e}")
    assert lv.shape == want_lv.shape == (65, 65, 65, 3)
    assert timage.shape == image.shape == (24, 24, 4)
    assert float(np.abs(want_lv).sum()) > 0.0
    assert image[..., 3].max() > 0.1
    assert rel_l1(lv, want_lv) < FRAME_REL_L1
    assert rel_l1(timage, image) < FRAME_REL_L1
    np.testing.assert_array_equal(tstate.light_volume_accum.numpy(), lv)


def test_radial_splat_and_sweep_match_float64_oracle(frame):
    """The port's own trace -> radial scatter splat -> sweep against a
    float64 numpy photon-map render (tests/test_golden_image.py)."""
    _, state0, _, _, tscene, tcfg = frame
    tstate = convert.state_from_numpy(leaves_of(state0), device="cpu")
    photons = tstep.full_trace_step(tscene, tstate, tcfg).photons
    lv_dim = (8, 8, 8)
    lv = tsplat.splat_all(photons, lv_dim, footprint=4, method="scatter")

    i, n, _ = photons.positions.shape
    pos = photons.positions.numpy().reshape(i * n, 3).astype(np.float64)
    pw = photons.powers.numpy().reshape(i * n, 3).astype(np.float64)
    valid = pos[:, 0] < 1e30
    assert valid.sum() > 100
    scale = float(constants.ISOTROPIC_PHASE * jtypes.relative_irradiance_scale(
        n, np.float32(photons.radius_rel)))
    lv_oracle = oracle.splat_oracle(pos, pw, valid, photons.radius_rel,
                                    scale, lv_dim)
    np.testing.assert_allclose(lv.numpy(), lv_oracle, rtol=RADIAL_RTOL,
                               atol=RADIAL_ATOL)

    cam = tscene.camera
    axis, sign = tsw.principal_axis(cam)
    _, inter, (u_lo, u_hi, v_lo, v_hi, za) = tsw._sweep_core(
        tscene.volume.data, tscene.tf, lv, cam, axis=axis, sign=sign,
        n_planes=32, inter_u=24, inter_v=24, width=24, height=24,
        ambient=0.05)
    V, U = inter.shape[:2]
    u = float(u_lo) + (np.arange(U) + 0.5) / U * float(u_hi - u_lo)
    v = float(v_lo) + (np.arange(V) + 0.5) / V * float(v_hi - v_lo)
    b_axis, c_axis = [a for a in range(3) if a != axis]
    P = np.zeros((V, U, 3), np.float64)
    P[..., axis] = float(za[0])
    P[..., b_axis] = u[None, :]
    P[..., c_axis] = v[:, None]
    o = np.broadcast_to(np.asarray(EYE, np.float64), P.shape).reshape(-1, 3)
    tf_pos, tf_cols = synthetic.default_tf_points()
    golden = oracle.dvr_zplane_oracle(
        tscene.volume.data.numpy().astype(np.float64),
        np.asarray(tf_pos, np.float64), np.asarray(tf_cols, np.float64),
        lv_oracle, o, P.reshape(-1, 3) - o, za.numpy().astype(np.float64),
        axis, 0.05).reshape(inter.shape)
    err = np.abs(inter.numpy() - golden)
    assert golden[..., 3].max() > 0.1
    assert err.max() < IMAGE_MAX_ERR, err.max()
    assert err.mean() < IMAGE_MEAN_ERR, err.mean()


def test_port_needs_no_jax():
    """With jax, jaxlib, flax and the reference package cpm_tpu all made
    unimportable, the port (time-varying playback included) and chip_smoke
    import, a 16^3 volume / 16^2 photon / 16^2 pixel frame runs on the
    CPU, asked for by name, and so do a correlated step through ``step()``
    with a checkpoint round trip before it, one ``advance_time`` of a
    16^3 x 3 sequence, a guided ``init_state`` with an area light beside
    the directional one, a marched render, a screen-weighted importance
    grid, a float16 frame, a trace without single scattering, NEE, the mesh
    spans, the debug image, a u3d file, trajectory gradients from an event
    tape, one gradient of examples/fit_tf_torch.py, the entry point's
    forward, a sharded and a multi-host step in a world of one gloo
    process, examples/render_sphere_torch.py's body and one packed
    ``interactive_frame``; no module of any of them is loaded afterwards,
    and no kernel was launched."""
    script = textwrap.dedent("""
        import sys
        blocked = ("jax", "jaxlib", "flax", "cpm_tpu")
        for name in blocked:
            sys.modules[name] = None
        import numpy as np
        import torch
        import cpm_tpu_torch
        import chip_smoke
        from cpm_tpu_torch.core import telemetry
        from cpm_tpu_torch.pipeline import timevarying

        def loaded():
            return [m for m in sys.modules if m.split(".")[0] in blocked
                    and sys.modules[m] is not None]

        assert not loaded(), loaded()
        scene, config = chip_smoke.build_frame(
            "cpu", vol_dim=16, photons=16, max_interactions=2,
            width=16, max_steps=500)
        state, image = chip_smoke.run_frame(scene, config)
        assert image.device.type == "cpu"
        assert tuple(image.shape) == (16, 16, 4)
        assert bool(torch.isfinite(image).all())
        assert int((state.photons.positions[..., 0] < 1e30).sum()) > 0

        import os, tempfile
        from cpm_tpu_torch.io import checkpoint
        from cpm_tpu_torch.pipeline import step
        from cpm_tpu_torch.pipeline.state import DirtyFlags
        grid = step.build_importance_grid(scene, config)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state")
            checkpoint.save_checkpoint(path, state, config)
            state, config = checkpoint.load_checkpoint(path, device="cpu")
        after = step.step(scene, state, config, DirtyFlags(tf=True), grid)
        assert after.recompute_phase == state.recompute_phase + 1
        assert int(after.retraced.sum()) + (after.n_remaining == 0) > 0
        assert after.light_volume.device.type == "cpu"
        assert bool(torch.isfinite(after.light_volume).all())

        import dataclasses
        from cpm_tpu_torch.core.lights import Light
        from cpm_tpu_torch.io import synthetic
        seq = timevarying.VolumeSequence.prepare(
            synthetic.time_varying_sequence(16, 3), device="cpu")
        moving = dataclasses.replace(scene, volume=dataclasses.replace(
            scene.volume, data=seq.volumes[0]))
        moving, played = timevarying.advance_time(moving, state, seq, 1.0,
                                                  config)
        assert torch.equal(moving.volume.data, seq.volumes[1])
        assert played.recompute_phase == state.recompute_phase + 1
        assert bool(torch.isfinite(played.light_volume).all())
        lit = dataclasses.replace(scene, lights=scene.lights + (
            Light.area((0.5, 1.5, 0.5), (0.0, -1.0, 0.0)),))
        guided = dataclasses.replace(config, guided_emission=True,
                                     guide_resolution=8)
        samples = step.init_state(lit, guided, importance_grid=grid
                                  ).light_samples
        assert samples.n == 2 * 16 * 16
        assert bool(torch.isfinite(samples.powers).all())

        from cpm_tpu_torch.io import u3d
        from cpm_tpu_torch.ops import debug, intersect, nee
        march = dataclasses.replace(config, render=dataclasses.replace(
            config.render, method="march"))
        img = step.render_state(scene, state, march)
        assert tuple(img.shape) == (16, 16, 4)
        assert bool(torch.isfinite(img).all())
        mixed = step.build_importance_grid(scene, config,
                                           screen_space_weight=0.5)
        assert bool((mixed.data <= grid.data + 1e-6).all())
        half = dataclasses.replace(config, tracer=dataclasses.replace(
            config.tracer, photon_dtype="float16"))
        halfst = step.full_trace_step(scene, step.init_state(scene, half),
                                      half)
        assert halfst.photons.positions.dtype == torch.float16
        assert bool(torch.isfinite(halfst.light_volume).all())
        from cpm_tpu_torch.ops import rng, tracer
        nss = dataclasses.replace(config.tracer, no_single_scattering=True)
        _, stats = tracer.trace_photons(
            scene.volume, scene.tf, scene.tf_scattering,
            state.light_samples, rng.prng_key(0), nss, return_stats=True)
        assert stats["wavefront_iters"] > 0
        light = Light.cone((0.5, 1.4, 0.5), (0.0, -1.0, 0.0))
        pts = torch.rand(8, 3)
        assert bool((nee.nee_single_scatter(light, scene.volume, scene.tf,
                                            pts, n_steps=8) >= 0).all())
        verts, faces = intersect.box_mesh(device="cpu")
        spans = intersect.light_sample_mesh_intersection(
            state.light_samples.origins, state.light_samples.directions,
            verts, faces)
        assert tuple(spans.shape) == (256, 2)
        image = debug.samples_to_image(torch.rand(64, 4), 4, 4)
        assert abs(float(image.mean()) - 1.0) < 1e-5
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "grid.u3d")
            u3d.write_u3d(path, np.ones((1, 2, 3, 4), np.float32))
            assert u3d.read_u3d(path).data.shape == (1, 2, 3, 4)
        from cpm_tpu_torch.ops import replay, score_grad
        ph, ev = tracer.trace_photons(
            scene.volume, scene.tf, scene.tf_scattering,
            state.light_samples, rng.prng_key(0), config.tracer,
            record_events=16)
        val, grads = score_grad.trajectory_gradients(
            scene.volume, scene.tf, scene.tf_scattering,
            state.light_samples, ph, ev, lambda dep: dep.sum())
        assert float(val) > 0.0
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "fit_tf_torch", os.path.join("examples", "fit_tf_torch.py"))
        fit = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = fit
        spec.loader.exec_module(fit)
        sc = fit.scene("cpu")
        photons, events = fit.trace(sc, fit.THETA_INIT, rng.prng_key(7))
        _, g = fit.theta_gradient(sc, fit.THETA_INIT, photons, events,
                                  torch.zeros(32, 32, 4))
        assert np.isfinite(g) and g != 0.0

        import torch.distributed as dist
        from cpm_tpu_torch import entry
        from cpm_tpu_torch.parallel import multihost, sharding
        forward, (tiny_scene, tiny_state) = entry.entry(device="cpu")
        assert bool(torch.isfinite(forward(tiny_scene, tiny_state)).all())
        os.environ.update(MASTER_ADDR="127.0.0.1", RANK="0", WORLD_SIZE="1",
                          MASTER_PORT=str(multihost.free_port()),
                          GLOO_SOCKET_IFNAME="lo")
        multihost.initialize_distributed("gloo")
        mesh = sharding.make_mesh()
        one = dataclasses.replace(state, light_samples=(
            sharding.shard_light_samples(state.light_samples, mesh)))
        _, img = sharding.sharded_full_step(scene, one, config, mesh)
        assert bool(torch.isfinite(img).all())
        grid2d = multihost.make_hosts_chips_mesh(1)
        _, img = multihost.multihost_full_step(scene, one, config, grid2d)
        assert bool(torch.isfinite(img).all())
        dist.destroy_process_group()
        spec = importlib.util.spec_from_file_location(
            "render_sphere_torch",
            os.path.join("examples", "render_sphere_torch.py"))
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        out = demo.render_sphere("cpu", vol_dim=16, photons_side=16,
                                 width=16)
        assert float(out["image"][..., 3].max()) > 0.0
        from cpm_tpu_torch.pipeline import packed
        frame, img = packed.interactive_frame(
            scene, packed.pack_state(state), scene.camera, grid, config,
            step.recompute_budget(config, state.photons.n),
            fresh_round=True)
        assert tuple(img.shape) == (16, 16, 4)
        assert bool(torch.isfinite(img).all())
        assert packed.unpack_state(frame).recompute_phase == (
            state.recompute_phase + 1)
        assert telemetry.launches("trace_woodcock_cuda") == 0
        assert telemetry.launches("splat_product_grad_cuda") == 0
        assert telemetry.launches("splat_product_direct") == 0
        assert telemetry.launches("splat_product_tiled") == 0
        assert telemetry.launches("bin_deposits") == 0
        assert not loaded(), loaded()
        for name in blocked:
            try:
                __import__(name)
            except ImportError:
                continue
            raise AssertionError(name + " is importable")
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")

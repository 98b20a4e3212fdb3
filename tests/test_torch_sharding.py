"""The port's data-parallel layer (``cpm_tpu_torch/parallel/sharding.py``)
against the port's single-device frame and the JAX reference: the splat's
``n_total`` on a half shard, and a world of 2 gloo processes on the CPU
(16^3 volume, 32^2 photons, 2 interactions, 24^2 pixels) running
``sharded_full_step`` with the sweep and with the marcher, each rank
started with ``python -c`` on a free port, as tests/test_sharding_fast.py
starts its devices.

The world's script serves tests/test_torch_multihost.py too (4 ranks as
2 hosts x 2 chips)."""

import json
import os
import subprocess
import sys
import textwrap

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
from cpm_tpu.core.config import RenderConfig as JRenderConfig
from cpm_tpu.core.config import TracerConfig as JTracerConfig
from cpm_tpu.io import synthetic
from cpm_tpu.ops import splat as jsplat
from cpm_tpu.pipeline import step as jstep
from cpm_tpu_torch.core import types as ttypes
from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                       TracerConfig)
from cpm_tpu_torch.core.lights import Light
from cpm_tpu_torch.io import convert
from cpm_tpu_torch.ops import splat as tsplat
from cpm_tpu_torch.parallel import multihost as mh
from cpm_tpu_torch.parallel import sharding as psh
from cpm_tpu_torch.pipeline import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A sharded frame against the port's single-device frame: the trace is
# bit-equal lane by lane; light volume and image differ by the order of
# the float32 sums (the ranks' partial grids).
RTOL, ATOL_REL = 1e-5, 1e-6
# Against JAX's single-device frame from the same converted state: the
# bound of tests/test_torch_pipeline.py (relative L1).
FRAME_REL_L1 = 1e-2
# splat_all(n_total=) against the reference's: the same float32 weights
# summed in another order.
SPLAT_RTOL, SPLAT_ATOL_REL = 1e-5, 1e-6

TRACER = dict(max_interactions=2, max_steps=2000)
RENDER = dict(width=24, height=24, sampling_rate=2.0)
PHOTONS = dict(photons_x=32, photons_y=32)
EYE = (0.45, 0.6, -1.5)
METHODS = ("sweep", "march")
PHOTON_FIELDS = ("positions", "powers", "directions", "exit_power",
                 "exit_direction")
WORLD_TIMEOUT_S = 240

# One rank: argv = (inputs .npz, options JSON, output .npz). It rebuilds
# the scene and the state from the converted arrays, runs one full step
# per render method over the mesh, counts the all_reduce calls of one
# trace + splat and, on the 2-D mesh, reports its groups.
RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                           TracerConfig)
    from cpm_tpu_torch.core.lights import Light
    from cpm_tpu_torch.io import convert
    from cpm_tpu_torch.ops import rng
    from cpm_tpu_torch.parallel import multihost as mh
    from cpm_tpu_torch.parallel import sharding as psh
    from cpm_tpu_torch.pipeline import step

    inputs = dict(np.load(sys.argv[1]))
    opts = json.loads(sys.argv[2])
    mh.initialize_distributed("gloo")
    rank = dist.get_rank()
    scene = convert.scene_from_numpy(
        inputs, [Light.directional((0.0, -1.0, 0.3))], device="cpu")
    state = convert.state_from_numpy(inputs, device="cpu")
    if opts["n_hosts"]:
        mesh = mh.make_hosts_chips_mesh(opts["n_hosts"])
        shard, full_step = mh.shard_light_samples_2d, mh.multihost_full_step
        trace_splat = mh.multihost_trace_splat
    else:
        mesh = psh.make_mesh()
        shard, full_step = psh.shard_light_samples, psh.sharded_full_step
        trace_splat = psh.sharded_trace_splat
    state = dataclasses.replace(state, light_samples=shard(
        state.light_samples, mesh))
    out = {}
    for method in opts["methods"]:
        config = PipelineConfig(
            tracer=TracerConfig(**opts["tracer"]),
            render=RenderConfig(method=method, **opts["render"]),
            **opts["photons"])
        new, img = full_step(scene, state, config, mesh)
        for f in ("positions", "powers", "directions", "exit_power",
                  "exit_direction"):
            out[f"{method}.photons.{f}"] = getattr(new.photons, f).numpy()
        out[f"{method}.light_volume"] = new.light_volume.numpy()
        out[f"{method}.image"] = img.numpy()

    calls = []
    real = dist.all_reduce
    def counted(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        name = ("chips" if opts["n_hosts"] and group is mesh.chips_group
                else "hosts" if opts["n_hosts"] and group is mesh.hosts_group
                else "world")
        calls.append([name, dist.get_world_size(group)])
        return real(tensor, op=op, group=group, async_op=async_op)
    dist.all_reduce = counted
    trace_splat(scene.volume, scene.tf, scene.tf_scattering,
                state.light_samples, rng.fold_in(state.key, 0),
                config.tracer, step.light_volume_shape(config),
                step.splat_footprint(config),
                step.splat_method(config, scene.device), mesh)
    dist.all_reduce = real
    out["all_reduce_calls"] = np.array(json.dumps(calls))
    if opts["n_hosts"]:
        out["groups"] = np.array(json.dumps({
            "host": mesh.host, "chip": mesh.chip,
            "chips": dist.get_process_group_ranks(mesh.chips_group),
            "hosts": dist.get_process_group_ranks(mesh.hosts_group)}))
    np.savez(sys.argv[3], **out)
    dist.destroy_process_group()
""")


def leaves_of(tree) -> dict:
    """A reference pytree as {field path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in flat}


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / np.abs(want).sum())


def reference_frame():
    """The JAX scene, its initial state, and the port's config for both
    render methods: {method: (port config, JAX config)}."""
    scene = jscene.Scene.create(
        jtypes.Volume.from_data(synthetic.smoke_cloud(16, seed=6)),
        jtypes.TransferFunction.from_points(*synthetic.default_tf_points()),
        jtypes.TransferFunction.from_points(
            *synthetic.default_scattering_points()),
        [jlights.Light.directional((0.0, -1.0, 0.3))],
        jcamera.Camera.create(eye=EYE))
    configs = {m: (PipelineConfig(tracer=TracerConfig(**TRACER),
                                  render=RenderConfig(method=m, **RENDER),
                                  **PHOTONS),
                   JPipelineConfig(tracer=JTracerConfig(**TRACER),
                                   render=JRenderConfig(method=m, **RENDER),
                                   **PHOTONS))
               for m in METHODS}
    state0 = jstep.init_state(scene, configs["sweep"][1])
    return scene, state0, configs


def start_world(world: int, inputs: dict, tmp, n_hosts: int = 0):
    """Start ``world`` ranks of RANK_SCRIPT on a free port; returns
    (processes, output paths)."""
    np.savez(tmp / "inputs.npz", **inputs)
    opts = json.dumps({"n_hosts": n_hosts, "methods": list(METHODS),
                       "tracer": TRACER, "render": RENDER,
                       "photons": PHOTONS})
    port = mh.free_port()
    procs, outs = [], []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1")
        outs.append(tmp / f"rank{rank}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(tmp / "inputs.npz"),
             opts, str(outs[-1])], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, outs


def finish_world(procs, outs) -> list:
    """Wait for every rank; returns each rank's outputs."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    return [dict(np.load(o)) for o in outs]


def run_world(world: int, tmp, n_hosts: int = 0) -> dict:
    """The world's outputs beside the port's and JAX's single-device
    frames from the same converted state."""
    torch.set_num_threads(1)
    jscene_, state0, configs = reference_frame()
    inputs = {**leaves_of(jscene_), **leaves_of(state0)}
    procs, outs = start_world(world, inputs, tmp, n_hosts)
    try:
        tscene = convert.scene_from_numpy(
            inputs, [Light.directional((0.0, -1.0, 0.3))], device="cpu")
        port, ref = {}, {}
        for m, (tcfg, jcfg) in configs.items():
            tstate = tstep.full_trace_step(
                tscene, convert.state_from_numpy(inputs, device="cpu"), tcfg)
            port[m] = (tstate, tstep.render_state(tscene, tstate,
                                                  tcfg).numpy())
            jstate = jstep.full_trace_step(jscene_, state0, jcfg)
            ref[m] = (np.asarray(jstate.light_volume),
                      np.asarray(jstep.render_state(jscene_, jstate, jcfg)))
    finally:
        ranks = finish_world(procs, outs)
    return {"ranks": ranks, "port": port, "jax": ref}


def expect_photons_equal(world: dict, method: str) -> None:
    """Every rank's photons equal the single-device trace's lanes of its
    slice, bit for bit."""
    single = world["port"][method][0].photons
    per = single.n // len(world["ranks"])
    for rank, out in enumerate(world["ranks"]):
        lanes = slice(rank * per, (rank + 1) * per)
        for f in PHOTON_FIELDS:
            want = getattr(single, f).numpy()
            want = want[:, lanes] if want.ndim == 3 else want[lanes]
            np.testing.assert_array_equal(
                out[f"{method}.photons.{f}"], want,
                err_msg=f"rank {rank}, photons.{f}")


def expect_frame_close(world: dict, method: str) -> None:
    """Every rank's light volume and image against the port's
    single-device frame (RTOL, ATOL_REL of its peak)."""
    state, image = world["port"][method]
    lv = state.light_volume.numpy()
    for rank, out in enumerate(world["ranks"]):
        for got, want, what in ((out[f"{method}.light_volume"], lv,
                                 "light volume"),
                                (out[f"{method}.image"], image, "image")):
            np.testing.assert_allclose(
                got, want, rtol=RTOL, atol=ATOL_REL * np.abs(want).max(),
                err_msg=f"rank {rank}, {what}")
    assert float(np.abs(lv).sum()) > 0.0 and image[..., 3].max() > 0.1


def expect_close_to_jax(world: dict, method: str) -> None:
    """Rank 0's frame against JAX's single-device frame (relative L1)."""
    want_lv, want_img = world["jax"][method]
    out = world["ranks"][0]
    lv_err = rel_l1(out[f"{method}.light_volume"], want_lv)
    img_err = rel_l1(out[f"{method}.image"], want_img)
    print(f"{method}: light volume rel L1 {lv_err:.3e}, image {img_err:.3e}")
    assert lv_err < FRAME_REL_L1 and img_err < FRAME_REL_L1


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, tmp_path_factory.mktemp("world2"))


@pytest.mark.parametrize("method", METHODS)
def test_sharded_photons_equal_single_device_lane_by_lane(world2, method):
    expect_photons_equal(world2, method)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_frame_matches_single_device(world2, method):
    expect_frame_close(world2, method)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_frame_matches_reference(world2, method):
    expect_close_to_jax(world2, method)


def test_one_all_reduce_per_sharded_trace_splat(world2):
    """The port's form of the reference's collective inventory
    (tests/test_multihost.py:136-150): one all_reduce over the world."""
    for out in world2["ranks"]:
        assert json.loads(str(out["all_reduce_calls"])) == [["world", 2]]


def test_shard_light_samples_raises_on_an_uneven_split():
    ls = ttypes.LightSamples(
        origins=torch.zeros(10, 3), directions=torch.zeros(10, 3),
        powers=torch.zeros(10, 3), tspan=torch.zeros(10, 2), iteration=0)
    with pytest.raises(ValueError):
        psh.shard_light_samples(ls, psh.Mesh(group=None, rank=0, size=3))
    half = psh.shard_light_samples(ls, psh.Mesh(group=None, rank=1, size=2))
    assert half.n == 5 and half.origins.data_ptr() == ls.origins[5:].data_ptr()


def _seeded_photons(n: int, max_i: int, seed: int, radius: float):
    """Seeded photons as both packages hold them, 30% of slots unused."""
    rs = np.random.default_rng(seed)
    pos = rs.uniform(0.05, 0.95, (max_i, n, 3)).astype(np.float32)
    pw = rs.uniform(0.1, 2.0, (max_i, n, 3)).astype(np.float32)
    pos[rs.random((max_i, n)) < 0.3] = np.float32(3.4028235e38)
    common = dict(directions=np.zeros((max_i, n, 2), np.float32),
                  exit_power=np.zeros(n, np.float32),
                  exit_direction=np.zeros((n, 2), np.float32))

    def both(lo, hi):
        sl = {"positions": pos[:, lo:hi], "powers": pw[:, lo:hi],
              "directions": common["directions"][:, lo:hi],
              "exit_power": common["exit_power"][lo:hi],
              "exit_direction": common["exit_direction"][lo:hi]}
        jph = jtypes.PhotonData(
            **{k: jnp.asarray(v) for k, v in sl.items()},
            radius_rel=jnp.float32(radius), scene_radius=jnp.float32(1.0),
            iteration=jnp.int32(0))
        tph = ttypes.PhotonData(
            **{k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sl.items()},
            radius_rel=float(np.float32(radius)), scene_radius=1.0)
        return jph, tph

    return both


def tsplat_all(photons, dim, n_total, method):
    return tsplat.splat_all(photons, dim, 4, n_total=n_total,
                            method=method).numpy()


@pytest.mark.parametrize("method", ["scatter", "matmul"])
def test_splat_all_n_total_on_a_half_shard_matches_reference(method):
    n, dim, radius = 512, (17, 17, 17), 0.07
    both = _seeded_photons(n, 2, seed=3, radius=radius)
    jph, tph = both(0, n // 2)
    want = np.asarray(jsplat.splat_all(jph, dim, footprint=4, n_total=n,
                                       method=method))
    got = tsplat_all(tph, dim, n, method)
    np.testing.assert_allclose(got, want, rtol=SPLAT_RTOL,
                               atol=SPLAT_ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("method", ["scatter", "matmul"])
def test_half_grids_with_n_total_sum_to_the_whole_grid(method):
    n, dim = 512, (17, 17, 17)
    both = _seeded_photons(n, 2, seed=4, radius=0.07)
    whole = tsplat_all(both(0, n)[1], dim, None, method)
    halves = sum(tsplat_all(both(lo, lo + n // 2)[1], dim, n, method)
                 for lo in (0, n // 2))
    np.testing.assert_allclose(halves, whole, rtol=SPLAT_RTOL,
                               atol=SPLAT_ATOL_REL * np.abs(whole).max())
    # Without n_total a half is normalized by its own count: twice as
    # bright.
    alone = tsplat_all(both(0, n // 2)[1], dim, None, method)
    np.testing.assert_allclose(
        alone, 2.0 * tsplat_all(both(0, n // 2)[1], dim, n, method),
        rtol=SPLAT_RTOL, atol=SPLAT_ATOL_REL * np.abs(alone).max())

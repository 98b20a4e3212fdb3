"""Entry points of the port (the twin of ``__graft_entry__.py``): one
forward step of the flagship pipeline, and a multi-device dry run.

    from cpm_tpu_torch import entry
    forward, (scene, state) = entry.entry()        # on the card
    image = forward(scene, state)
    entry.dryrun_multichip(2, backend="gloo")       # two ranks on one card
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from cpm_tpu_torch.core.camera import Camera
from cpm_tpu_torch.core.config import (PipelineConfig, RenderConfig,
                                       TracerConfig)
from cpm_tpu_torch.core.lights import Light
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import TransferFunction, Volume
from cpm_tpu_torch.io import convert, synthetic
from cpm_tpu_torch.ops import sweep_render as sw
from cpm_tpu_torch.parallel import multihost as mh
from cpm_tpu_torch.parallel import sharding as psh
from cpm_tpu_torch.pipeline import step as pstep

# A sharded frame against the single-device one: the trace is bit-equal
# lane by lane, the light volume and the image differ by the order of the
# float32 sums (the ranks' partial grids, the kernel's atomics).
RTOL = 1e-5
ATOL_REL = 1e-6  # absolute tolerance, relative to max |single-device|


def _tiny_setup(photons_side: int = 32, vol_dim: int = 32, img: int = 32,
                device=None):
    """(scene, initial state, config): a sphere in a box, one directional
    light, 2 interactions, on the card unless ``device`` names another."""
    volume = Volume.from_data(synthetic.sphere_in_box(vol_dim),
                              device=device)
    tf = TransferFunction.from_points(*synthetic.default_tf_points(),
                                      device=device)
    tfs = TransferFunction.from_points(
        *synthetic.default_scattering_points(), device=device)
    scene = Scene.create(volume, tf, tfs,
                         [Light.directional((0.0, -1.0, 0.3))],
                         Camera.create(device=device))
    config = PipelineConfig(
        photons_x=photons_side, photons_y=photons_side,
        tracer=TracerConfig(max_interactions=2, max_steps=2000),
        render=RenderConfig(width=img, height=img))
    state = pstep.init_state(scene, config)
    return scene, state, config


def entry(device=None):
    """(forward, (scene, state)): one forward step of the flagship
    pipeline, a full photon trace + splat + sweep compositing. The camera's
    principal axis is resolved here from the concrete camera, as the
    reference does, and ``forward`` renders along it."""
    scene, state, config = _tiny_setup(device=device)
    axis, sign = sw.principal_axis(scene.camera)
    rcfg = config.render
    na = scene.volume.data.shape[2 - axis]
    n_planes = max(2, int(na * rcfg.sampling_rate))
    u = sw._round_up(int(rcfg.width * rcfg.inter_scale), 128)
    v = sw._round_up(int(rcfg.height * rcfg.inter_scale), 128)

    def forward(scene, state):
        new_state = pstep.full_trace_step(scene, state, config)
        img, _, _ = sw._sweep_core(
            scene.volume.data, scene.tf, new_state.light_volume_accum,
            scene.camera, axis=axis, sign=sign, n_planes=n_planes,
            inter_u=u, inter_v=v, width=rcfg.width, height=rcfg.height,
            ambient=rcfg.ambient)
        return img

    return forward, (scene, state)


def _side(n_devices: int) -> int:
    """Photons and pixels per axis: 32, or rounded up so that side * side
    splits over ``n_devices`` ranks."""
    side = 32
    if (side * side) % n_devices:
        side = -(-side // n_devices) * n_devices
    return side


def _expect_close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    torch.testing.assert_close(
        got.cpu(), want.cpu(), rtol=RTOL,
        atol=ATOL_REL * float(want.abs().max()),
        msg=lambda m: f"{what}: {m}")


def _expect_frame(what: str, got_state, got_img, want_state, want_img,
                  rows: slice) -> None:
    """A sharded frame against the single-device one: this rank's photons
    bit for bit, the light volume and the image within RTOL, ATOL_REL."""
    for field in ("positions", "powers", "directions"):
        want = getattr(want_state.photons, field)[:, rows]
        if not torch.equal(getattr(got_state.photons, field).cpu(),
                           want.cpu()):
            raise AssertionError(f"{what}: photons.{field} differ from the "
                                 "single-device trace")
    for field in ("exit_power", "exit_direction"):
        if not torch.equal(getattr(got_state.photons, field).cpu(),
                           getattr(want_state.photons, field)[rows].cpu()):
            raise AssertionError(f"{what}: photons.{field} differ from the "
                                 "single-device trace")
    _expect_close(got_state.light_volume, want_state.light_volume,
                  f"{what}: light volume")
    _expect_close(got_img, want_img, f"{what}: image")


def _dryrun_rank(rank: int, n_devices: int, side: int, device,
                 data_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: the sharded step (and, for an
    even world above 1, the 2-host step) from the converted initial state
    in ``data_dir``, held against the single-device frame saved there."""
    torch.set_num_threads(1)
    scene, _, config = _tiny_setup(photons_side=side, img=side,
                                   device=device)
    state = convert.state_from_numpy(
        dict(np.load(os.path.join(data_dir, "state.npz"))),
        device=scene.device)
    single = dict(np.load(os.path.join(data_dir, "single.npz")))
    want_image = torch.from_numpy(single.pop("image"))
    want_state = convert.state_from_numpy(single, device="cpu")

    mesh = psh.make_mesh()
    rows = psh._rows(state.light_samples.n, mesh)
    sharded = dataclasses.replace(
        state, light_samples=psh.shard_light_samples(state.light_samples,
                                                     mesh))
    got, img = psh.sharded_full_step(scene, sharded, config, mesh)
    _expect_frame(f"rank {rank}: sharded_full_step", got, img, want_state,
                  want_image, rows)
    if n_devices % 2 == 0 and n_devices > 1:
        mesh2 = mh.make_hosts_chips_mesh(n_hosts=2)
        state2 = dataclasses.replace(
            state, light_samples=mh.shard_light_samples_2d(
                state.light_samples, mesh2))
        got, img = mh.multihost_full_step(scene, state2, config, mesh2)
        _expect_frame(f"rank {rank}: multihost_full_step", got, img,
                      want_state, want_image, rows)


def dryrun_multichip(n_devices: int, backend: str, device=None) -> None:
    """Start a world of ``n_devices`` processes with ``backend`` on this
    host and run one sharded step on tiny shapes: the 1-D data-parallel
    mesh (:mod:`cpm_tpu_torch.parallel.sharding`) and, when the ranks split
    in two, the (2 hosts, chips) mesh with its chips-then-hosts reduction
    (:mod:`cpm_tpu_torch.parallel.multihost`). Every rank starts from the
    same converted state and holds its photons, the light volume and the
    image against the single-device frame this process computes; a rank
    that disagrees makes this raise."""
    side = _side(n_devices)
    scene, state, config = _tiny_setup(photons_side=side, img=side,
                                       device=device)
    single = pstep.full_trace_step(scene, state, config)
    image = pstep.render_state(scene, single, config).cpu().numpy()
    if image.shape != (side, side, 4) or not np.isfinite(image).all():
        raise AssertionError("the single-device frame is misshapen or not "
                             "finite")
    # The states go by file: a spawned rank's arguments stay small.
    with tempfile.TemporaryDirectory() as data_dir:
        np.savez(os.path.join(data_dir, "state.npz"),
                 **convert.state_to_numpy(state))
        np.savez(os.path.join(data_dir, "single.npz"),
                 **convert.state_to_numpy(single), image=image)
        mh.launch_local_world(
            _dryrun_rank, n_devices, backend,
            (n_devices, side, None if device is None else str(device),
             data_dir))

"""Multi-host distribution over a (hosts, chips) grid of ranks
(``cpm_tpu/parallel/multihost.py``) on ``torch.distributed``.

Rank r sits at (host r // chips, chip r % chips). Photons and camera rays
are split over all the ranks, in rank order, as in
:mod:`cpm_tpu_torch.parallel.sharding`, so the trace and the ray march
need no communication. The light volume is reduced in two stages: an
``all_reduce`` within each host (the "chips" groups, over NVLink), then
one across the hosts (the "hosts" groups, over the network), which moves
one small grid per host. Random streams are keyed by the global lane id,
so the photons do not depend on how the lanes land on hosts and chips.

:func:`initialize_distributed` brings the world up from the launcher's
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``);
:func:`launch_local_world` starts a world of processes on this host.
"""

from __future__ import annotations

import os
import socket
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cpm_tpu_torch.core.config import PipelineConfig
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import LightSamples, TransferFunction, Volume
from cpm_tpu_torch.ops import rng
from cpm_tpu_torch.parallel import sharding
from cpm_tpu_torch.pipeline import step as pstep
from cpm_tpu_torch.pipeline.state import PhotonMapState

Tensor = torch.Tensor


def initialize_distributed(backend: str) -> None:
    """Join the world the launcher describes in ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` with ``backend`` ("nccl"
    across cards; "gloo" for several ranks on one card or on the CPU).
    First, where there is a card, the rank takes card
    ``LOCAL_RANK`` (else ``RANK``) modulo the cards of the host as its
    current device, which ``device=None`` then means.

    Does nothing when a process group is already up, or when
    ``WORLD_SIZE`` is unset (a single process). A failed init of a
    configured world raises."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method="env://")


@dataclass(frozen=True)
class HostsChipsMesh:
    """The 2-D (hosts, chips) mesh: this rank's place and the process
    groups of its host row ("chips") and its chip column ("hosts");
    ``flat`` is the 1-D mesh over the whole world, in rank order."""

    n_hosts: int
    n_chips: int
    host: int
    chip: int
    chips_group: dist.ProcessGroup
    hosts_group: dist.ProcessGroup
    flat: sharding.Mesh


def make_hosts_chips_mesh(n_hosts: int) -> HostsChipsMesh:
    """The (n_hosts, world / n_hosts) mesh over the initialized world.
    Every rank creates every group, in the same order (``new_group`` is
    collective): first one per host row, then one per chip column."""
    world = dist.get_world_size()
    if n_hosts < 1 or world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    n_chips = world // n_hosts
    rank = dist.get_rank()
    host, chip = divmod(rank, n_chips)
    rows = [dist.new_group([h * n_chips + c for c in range(n_chips)])
            for h in range(n_hosts)]
    cols = [dist.new_group([h * n_chips + c for h in range(n_hosts)])
            for c in range(n_chips)]
    return HostsChipsMesh(n_hosts=n_hosts, n_chips=n_chips, host=host,
                          chip=chip, chips_group=rows[host],
                          hosts_group=cols[chip],
                          flat=sharding.make_mesh())


def shard_light_samples_2d(ls: LightSamples,
                           mesh: HostsChipsMesh) -> LightSamples:
    """This rank's slice of the light samples over the flattened
    (hosts, chips) grid."""
    return sharding.shard_light_samples(ls, mesh.flat)


def multihost_trace_splat(volume: Volume, tf: TransferFunction,
                          tf_scattering: TransferFunction,
                          light_samples: LightSamples, key: tuple, config,
                          out_dim: tuple, footprint: int, method: str,
                          mesh: HostsChipsMesh):
    """Trace + splat of this rank's slice; the light volume is reduced
    within the host first, then across the hosts. Returns (this rank's
    photons, the light volume on every rank)."""
    photons, lv = sharding.trace_splat_shard(
        volume, tf, tf_scattering, light_samples, key, config, out_dim,
        footprint, method, mesh.flat.rank, mesh.flat.size)
    dist.all_reduce(lv, op=dist.ReduceOp.SUM, group=mesh.chips_group)
    dist.all_reduce(lv, op=dist.ReduceOp.SUM, group=mesh.hosts_group)
    return photons, lv


def multihost_render_rays(volume: Volume, tf: TransferFunction,
                          light_volume: Tensor, o: Tensor, d: Tensor,
                          n_steps: int, ambient: float,
                          mesh: HostsChipsMesh) -> Tensor:
    """Camera rays split over the flattened grid; the scene replicated."""
    return sharding.sharded_render_rays(volume, tf, light_volume, o, d,
                                        n_steps, ambient, mesh.flat)


def multihost_full_step(scene: Scene, state: PhotonMapState,
                        config: PipelineConfig, mesh: HostsChipsMesh):
    """A full pipeline step over the (hosts, chips) mesh, the twin of
    :func:`cpm_tpu_torch.parallel.sharding.sharded_full_step`; the sweep
    splits its columns over the whole world."""
    photons, lv = multihost_trace_splat(
        scene.volume, scene.tf, scene.tf_scattering, state.light_samples,
        rng.fold_in(state.key, 0), config.tracer,
        pstep.light_volume_shape(config), pstep.splat_footprint(config),
        pstep.splat_method(config, scene.device), mesh)
    return sharding.finish_step(scene, state, config, photons, lv,
                                mesh.flat)


def dcn_scaling_budget(config: PipelineConfig, step_time_s: float,
                       n_hosts: int = 4, dcn_bytes_per_s: float = 25e9,
                       overlap: float = 0.0) -> dict:
    """Predicted multi-host scaling efficiency from first principles.

    The per-step communication is one light-volume reduction: within each
    host, then a ring all-reduce of the (D, H, W, 3) float32 grid across
    the hosts, which moves 2 (n - 1) / n of its bytes per host. The trace,
    the splat and the render are split with no communication.

    efficiency = t_compute / (t_compute + (1 - overlap) * t_dcn), with
    t_compute = step_time_s / n_hosts (a perfect split of a measured
    single-device step) and t_dcn = 2 (n - 1) / n * grid bytes /
    ``dcn_bytes_per_s``. ``overlap=0`` is the pessimistic bound.
    """
    d, h, w = pstep.light_volume_shape(config)
    lv_bytes = d * h * w * 3 * 4
    t_dcn = 2.0 * (n_hosts - 1) / n_hosts * lv_bytes / dcn_bytes_per_s
    t_compute = step_time_s / n_hosts
    eff = t_compute / (t_compute + (1.0 - overlap) * t_dcn)
    return {
        "light_volume_bytes": lv_bytes,
        "dcn_bytes_per_step_per_host": 2.0 * (n_hosts - 1) / n_hosts
                                       * lv_bytes,
        "t_dcn_s": t_dcn,
        "t_compute_s": t_compute,
        "efficiency": eff,
        "meets_85pct_target": eff >= 0.85,
    }


# --- a world of processes on this host --------------------------------------

def free_port() -> int:
    """A TCP port on the loopback interface that no one listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world_size: int, backend: str, port: int,
               args: tuple) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank))
    # All ranks are on this host: gloo talks over the loopback interface.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    initialize_distributed(backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def launch_local_world(fn, world_size: int, backend: str, args: tuple = (),
                       timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes (spawned)
    joined into one world with ``backend`` on this host, and wait for all
    of them. ``fn`` must be importable by name. A rank that raises makes
    this raise with its traceback (the others are terminated); after
    ``timeout_s`` every rank is killed and TimeoutError raised."""
    ctx = mp.spawn(_rank_main, args=(fn, world_size, backend, free_port(),
                                     tuple(args)),
                   nprocs=world_size, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world_size} ranks did not "
                                   f"finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()

"""Data-parallel distribution of the photon-mapping pipeline over the ranks
of a ``torch.distributed`` world (``cpm_tpu/parallel/sharding.py``).

One process per rank. The light samples (and so the photons) and the
camera's pixels are split over the ranks along their leading axis, in
contiguous slices; the scene is replicated. The trace and the ray march
need no communication:

- every rank splats its photons into a private partial grid normalized by
  the GLOBAL photon count (``splat_all(n_total=)``), and one
  ``all_reduce(SUM)`` of the small (D, H, W, 3) grid gives every rank the
  light volume; it equals the single-device grid up to the order of the
  float32 sums;
- random streams are keyed by the global lane id, so a photon's
  trajectory does not depend on which rank traced it;
- the sweep splits its intermediate image by U columns and gathers it once
  before the warp; the marcher splits the pixel bundle.

Backends: NCCL across cards; gloo for several ranks on one card (NCCL
refuses two ranks on one GPU) and on the CPU. Gloo's ``all_reduce`` takes
CUDA tensors, its ``all_gather`` CPU tensors only (torch.distributed's
table of collectives by backend), so :func:`all_gather_cat` copies through
the host there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from cpm_tpu_torch.core.config import PipelineConfig, RenderConfig
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      TransferFunction, Volume, f32_scalar,
                                      full_fp32_matmul)
from cpm_tpu_torch.ops import gather, rng, splat, tracer
from cpm_tpu_torch.ops import sweep_render as sw
from cpm_tpu_torch.pipeline import step as pstep
from cpm_tpu_torch.pipeline.state import PhotonMapState

Tensor = torch.Tensor


@dataclass(frozen=True)
class Mesh:
    """The port's 1-D mesh: a process group and this process's place in
    it."""

    group: dist.ProcessGroup
    rank: int
    size: int
    axis_name: str = "data"


def make_mesh(group: dist.ProcessGroup | None = None,
              axis_name: str = "data") -> Mesh:
    """The 1-D mesh over ``group`` (the whole world by default); the
    process group must be initialized."""
    group = dist.group.WORLD if group is None else group
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), axis_name=axis_name)


def _rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous slice of ``n`` rows."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_light_samples(ls: LightSamples, mesh: Mesh) -> LightSamples:
    """This rank's contiguous slice of the light samples; ``iteration`` is
    replicated. Raises unless the ranks split the samples evenly."""
    rows = _rows(ls.n, mesh)
    return LightSamples(
        origins=ls.origins[rows], directions=ls.directions[rows],
        powers=ls.powers[rows], tspan=ls.tspan[rows],
        iteration=ls.iteration)


def all_gather_cat(t: Tensor, mesh: Mesh, dim: int = 0) -> Tensor:
    """Every rank's ``t`` (one shape on all) concatenated along ``dim`` in
    rank order, on every rank. Gloo gathers CPU tensors only, so a CUDA
    tensor under gloo goes to the host and back."""
    via_host = t.is_cuda and dist.get_backend(mesh.group) == "gloo"
    src = (t.cpu() if via_host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if via_host else out


def trace_splat_shard(volume: Volume, tf: TransferFunction,
                      tf_scattering: TransferFunction,
                      light_samples: LightSamples, key: tuple, config,
                      out_dim: tuple, footprint: int, method: str,
                      shard: int, n_shards: int):
    """Trace shard ``shard`` of ``n_shards`` equal slices (its lanes keep
    their global ids, so their random streams) and splat it normalized by
    the global photon count: (photons, partial (D, H, W, 3) grid).
    ``config`` is a TracerConfig; a ``trace_chunk`` chunks the slice."""
    per = light_samples.n
    lane_ids = shard * per + torch.arange(per, dtype=torch.int64,
                                          device=volume.device)
    photons = tracer.trace_photons_chunked(
        volume, tf, tf_scattering, light_samples, key, config,
        config.trace_chunk or per, lane_ids=lane_ids)
    partial = splat.splat_all(photons, out_dim, footprint,
                              n_total=per * n_shards, method=method)
    return photons, partial


def sharded_trace_splat(volume: Volume, tf: TransferFunction,
                        tf_scattering: TransferFunction,
                        light_samples: LightSamples, key: tuple, config,
                        out_dim: tuple, footprint: int, method: str,
                        mesh: Mesh):
    """Trace this rank's slice of the light samples
    (:func:`shard_light_samples`) and reduce the ranks' partial grids with
    one ``all_reduce``.

    Returns (this rank's photons, the (D, H, W, 3) light volume, the same
    on every rank). ``footprint`` is
    :func:`cpm_tpu_torch.pipeline.step.splat_footprint`'s, so the grid
    matches the single-device one for any config."""
    photons, lv = trace_splat_shard(
        volume, tf, tf_scattering, light_samples, key, config, out_dim,
        footprint, method, mesh.rank, mesh.size)
    dist.all_reduce(lv, op=dist.ReduceOp.SUM, group=mesh.group)
    return photons, lv


def sharded_sweep_render(volume: Volume, tf: TransferFunction,
                         light_volume: Tensor, camera, config: RenderConfig,
                         mesh: Mesh) -> Tensor:
    """Shear-warp render with the intermediate image split by U columns:
    each rank scans every plane for its columns (the volume and the light
    volume are replicated), the columns are gathered once, and every rank
    warps the whole image to the screen.

    The intermediate grid is the single-device sweep's; where the ranks do
    not divide its U columns, the last rank's slice is padded with copies
    of the last column, which the gather drops. (The reference rounds U
    itself up to a multiple of the devices, which changes the grid and so
    the image.) As in the reference's sharded sweep, an eye inside the
    volume's slab range is not handled here: this is one sweep along the
    camera's marching sign."""
    full_fp32_matmul()
    axis, sign = sw.principal_axis(camera)
    na = volume.data.shape[2 - axis]
    n_planes = max(2, int(na * config.sampling_rate))
    u_cols = sw._round_up(int(config.width * config.inter_scale), 128)
    v_rows = sw._round_up(int(config.height * config.inter_scale), 128)
    vol_p, light_p = sw.permute_volumes(volume.data, light_volume, axis)
    sched = sw._plane_schedule(camera, axis, sign, n_planes, config.width,
                               config.height)
    u, v = sw.base_grid(sched, u_cols, v_rows)
    padded = sw._round_up(u_cols, mesh.size)
    u = torch.cat([u, u[-1:].expand(padded - u_cols)])
    mine = sw._scan_planes(vol_p, light_p, tf, sched, u[_rows(padded, mesh)],
                           v, config.ambient)
    inter = all_gather_cat(mine, mesh, dim=1)[:, :u_cols]
    return sw._warp(inter, sched, axis, config.width, config.height)


def sharded_render_rays(volume: Volume, tf: TransferFunction,
                        light_volume: Tensor, o: Tensor, d: Tensor,
                        n_steps: int, ambient: float, mesh: Mesh) -> Tensor:
    """Ray-march a flat (P, 3) bundle split over the ranks (with row-major
    pixels, each rank marches whole rows when the ranks divide the
    height); every rank returns all (P, 4) results."""
    rows = _rows(o.shape[0], mesh)
    mine = gather.render_rays(volume, tf, light_volume, o[rows], d[rows],
                              n_steps, ambient)
    return all_gather_cat(mine, mesh)


def finish_step(scene: Scene, state: PhotonMapState, config: PipelineConfig,
                photons: PhotonData, lv: Tensor, mesh: Mesh):
    """The state after a traced and reduced step, and its image rendered
    over ``mesh``: what :func:`sharded_full_step` and the multi-host step
    share."""
    photons = dataclasses.replace(
        photons, radius_rel=f32_scalar(config.tracer.radius_rel),
        scene_radius=scene.volume.scene_radius(), iteration=0)
    state = dataclasses.replace(
        state, photons=photons, light_volume=lv, light_volume_accum=lv,
        retraced=torch.zeros(photons.n, dtype=torch.bool,
                             device=scene.device),
        n_remaining=0)
    rcfg = config.render
    if rcfg.method == "sweep":
        return state, sharded_sweep_render(scene.volume, scene.tf, lv,
                                           scene.camera, rcfg, mesh)
    if rcfg.method != "march":
        raise ValueError(f"unknown render method {rcfg.method!r}")
    origins, dirs = scene.camera.rays(rcfg.width, rcfg.height)
    img = sharded_render_rays(
        scene.volume, scene.tf, lv, origins.reshape(-1, 3),
        dirs.reshape(-1, 3),
        gather.default_steps(scene.volume, rcfg.sampling_rate),
        rcfg.ambient, mesh)
    return state, img.reshape(rcfg.height, rcfg.width, 4)


def sharded_full_step(scene: Scene, state: PhotonMapState,
                      config: PipelineConfig, mesh: Mesh):
    """One full pipeline step (trace -> splat -> all_reduce -> render)
    over the mesh: the multi-device twin of
    :func:`cpm_tpu_torch.pipeline.step.full_trace_step` followed by
    :func:`render_state`. ``state.light_samples`` is this rank's slice
    (:func:`shard_light_samples`).

    Returns (the new state, whose photons are this rank's, the full
    (H, W, 4) image on every rank)."""
    photons, lv = sharded_trace_splat(
        scene.volume, scene.tf, scene.tf_scattering, state.light_samples,
        rng.fold_in(state.key, 0), config.tracer,
        pstep.light_volume_shape(config), pstep.splat_footprint(config),
        pstep.splat_method(config, scene.device), mesh)
    return finish_step(scene, state, config, photons, lv, mesh)

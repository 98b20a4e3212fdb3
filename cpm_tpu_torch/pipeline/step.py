"""Pipeline orchestration (``cpm_tpu/pipeline/step.py``): each path is a
function over (Scene, PhotonMapState), and :func:`step` dispatches on
:class:`~cpm_tpu_torch.pipeline.state.DirtyFlags`.

- :func:`init_state`, :func:`full_trace_step`, :func:`render_state`: the
  forward frame (trace all photons, full splat, sweep render, or the
  gather marcher with ``render.method="march"``).
- :func:`correlated_step`: importance-ranked selective retrace and the
  incremental -1/+1 resplat; :func:`correlated_step_scalable` is the same
  update with two splats (removed, added) in place of the signed one.
- :func:`progressive_step`: one refinement tick (next iteration, smaller
  radius, a fresh photon wave folded into the running average);
  :func:`progressive_step_guided` re-emits each wave by the contribution
  guide of the one before.
- :func:`build_importance_grid`, :func:`build_tf_change_importance_grid`:
  the importance grids the correlated update ranks photons by.

Everything runs on the device of the scene's tensors. ``n_remaining``,
``recompute_phase`` and the progressive iteration are Python ints in the
state, so a correlated step reads its counts back from the device once.

Each path is a span of the recorder (``core/telemetry.py``), and each
stage of a correlated step a span inside it; every wait of the host for
the card goes through the recorder's ``wait``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from cpm_tpu_torch.core import lights as L
from cpm_tpu_torch.core import telemetry
from cpm_tpu_torch.core.config import PipelineConfig
from cpm_tpu_torch.core.scene import Scene
from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      UniformGrid3D, f32_scalar,
                                      progressive_sphere_radius)
from cpm_tpu_torch.ops import emit as emit_mod
from cpm_tpu_torch.ops import importance as importance_mod
from cpm_tpu_torch.ops import (gather, minmax, path_importance, rng, sampling,
                               screen_importance, select, splat, sweep_render,
                               tracer)
from cpm_tpu_torch.pipeline.state import DirtyFlags, PhotonMapState

Tensor = torch.Tensor


def emit_all(scene: Scene, config: PipelineConfig, key: tuple,
             importance_grid: UniformGrid3D | None = None) -> LightSamples:
    """Emit the light-sample bundle of every light, concatenated: N =
    photons_x * photons_y samples per light, in linear or Hilbert order
    (``config.sample_order``); light i draws under ``fold_in(key, i)``.

    With ``config.guided_emission`` and an importance grid, each
    directional light's sample grid is warped by the grid's projection
    onto its light plane; the warp's pdf keeps power / pdf unbiased."""
    grid = sampling.stratified_grid_2d(config.photons_x, config.photons_y,
                                       device=scene.device)
    if config.sample_order == "hilbert":
        order = max(config.photons_x, config.photons_y).bit_length()
        idx = sampling.hilbert_index_2d(grid[:, 0], grid[:, 1], order=order)
        grid = grid[torch.argsort(idx, stable=True)]
    bundles = []
    for i, light in enumerate(scene.lights):
        g = grid
        if (config.guided_emission and importance_grid is not None
                and light.type == L.DIRECTIONAL):
            guide = emit_mod.build_emission_guide(
                importance_grid, light, n_u=config.guide_resolution,
                n_v=config.guide_resolution)
            g = sampling.warp_samples_2d(grid, guide,
                                         floor=config.guide_floor)
        bundles.append(emit_mod.emit(light, g, key=rng.fold_in(key, i)))
    if len(bundles) == 1:
        return bundles[0]
    return LightSamples(
        origins=torch.cat([b.origins for b in bundles]),
        directions=torch.cat([b.directions for b in bundles]),
        powers=torch.cat([b.powers for b in bundles]),
        tspan=torch.cat([b.tspan for b in bundles]),
        iteration=bundles[0].iteration,
    )


def light_volume_shape(config: PipelineConfig) -> tuple:
    if config.splat.volume_size_from_radius:
        d = splat.light_volume_dim(config.tracer.radius_rel)
    else:
        d = config.splat.volume_dim
    return (d, d, d)


def splat_method(config: PipelineConfig, device: torch.device) -> str:
    """Resolve the splat backend ("auto" picks by the tensors' device)."""
    if config.splat.method == "auto":
        return splat.default_method(device)
    return config.splat.method


def splat_footprint(config: PipelineConfig) -> int:
    """Static radial-splat footprint, validated against the photon radius:
    the AABB spans at most floor(2*r*dim) + 2 voxels per axis."""
    dim = max(light_volume_shape(config))
    required = int(2.0 * config.tracer.radius_rel * dim) + 2
    fp = max(config.splat.footprint, required)
    if fp > 16:
        raise ValueError(
            f"splat footprint {fp} (radius_rel={config.tracer.radius_rel}, "
            f"light volume dim={dim}) exceeds 16 voxels; use a coarser light "
            "volume or a smaller radius")
    return fp


def init_state(scene: Scene, config: PipelineConfig, seed: int = 0,
               importance_grid: UniformGrid3D | None = None,
               light_samples: LightSamples | None = None) -> PhotonMapState:
    """Fresh state: emitted light samples, empty photon buffer, zero light
    volume; ``seed`` roots the state's threefry key, and emission draws
    under ``fold_in(key, 1)``. Pass ``importance_grid`` (with
    ``config.guided_emission``) for importance-guided emission, or a
    bundle built elsewhere as ``light_samples`` (e.g. one guided by
    :func:`emit_mod.emission_guide_from_wave`)."""
    key = rng.prng_key(seed)
    ls = light_samples
    if ls is None:
        ls = emit_all(scene, config, rng.fold_in(key, 1),
                      importance_grid=importance_grid)
    dev = scene.device
    photons = PhotonData.create(
        ls.n, config.tracer.max_interactions,
        radius_rel=config.tracer.radius_rel,
        scene_radius=scene.volume.scene_radius(), device=dev)
    zeros = torch.zeros((*light_volume_shape(config), 3),
                        dtype=torch.float32, device=dev)
    return PhotonMapState(
        photons=photons, light_samples=ls, light_volume=zeros,
        light_volume_accum=zeros, key=key,
        retraced=torch.zeros(ls.n, dtype=torch.bool, device=dev),
        n_remaining=0, recompute_phase=0)


def _trace(scene: Scene, samples: LightSamples, key: tuple,
           config: PipelineConfig,
           lane_ids: Tensor | None = None) -> PhotonData:
    """Trace a bundle, in chunks of ``config.tracer.trace_chunk`` lanes
    where that is set and the bundle is larger; the chunked trace is
    bit-identical to the trace in one piece."""
    chunk = config.tracer.trace_chunk
    if chunk and samples.n > chunk:
        return tracer.trace_photons_chunked(
            scene.volume, scene.tf, scene.tf_scattering, samples, key,
            config.tracer, chunk, lane_ids=lane_ids)
    return tracer.trace_photons(
        scene.volume, scene.tf, scene.tf_scattering, samples, key,
        config.tracer, lane_ids=lane_ids)


@telemetry.spanned("pipeline.full_trace_step")
def full_trace_step(scene: Scene, state: PhotonMapState,
                    config: PipelineConfig) -> PhotonMapState:
    """Trace every light sample and rebuild the light volume, restarting
    the progressive iteration at 0."""
    iteration = 0
    key = rng.fold_in(state.key, iteration)
    photons = _trace(scene, state.light_samples, key, config)
    photons = dataclasses.replace(
        photons, iteration=iteration,
        radius_rel=f32_scalar(config.tracer.radius_rel),
        scene_radius=scene.volume.scene_radius())
    lv = splat.splat_all(photons, light_volume_shape(config),
                         splat_footprint(config),
                         method=splat_method(config, scene.device))
    return dataclasses.replace(
        state, photons=photons, light_volume=lv, light_volume_accum=lv,
        retraced=torch.zeros(photons.n, dtype=torch.bool,
                             device=scene.device),
        n_remaining=0)


@telemetry.spanned("pipeline.progressive_step")
def progressive_step(scene: Scene, state: PhotonMapState,
                     config: PipelineConfig) -> PhotonMapState:
    """One progressive-refinement tick: advance the iteration, shrink the
    radius by the Knaus-Zwicker schedule, trace a fresh photon wave with new
    random streams and fold its light volume into the running average."""
    iteration = state.photons.iteration + 1
    radius = progressive_sphere_radius(state.photons.radius_rel, iteration,
                                       config.tracer.alpha)
    key = rng.fold_in(state.key, iteration)
    photons = _trace(scene, state.light_samples, key, config)
    photons = dataclasses.replace(
        photons, iteration=iteration, radius_rel=radius,
        scene_radius=scene.volume.scene_radius())
    lv = splat.splat_all(photons, light_volume_shape(config),
                         splat_footprint(config),
                         method=splat_method(config, scene.device))
    # Divisor as a device tensor: a CUDA tensor divided by a host number
    # is multiplied by its rounded reciprocal instead.
    it = telemetry.wait("step.iteration", torch.tensor, float(iteration),
                        dtype=torch.float32, device=scene.device)
    accum = (state.light_volume_accum * it + lv) / (it + 1.0)
    return dataclasses.replace(state, photons=photons, light_volume=lv,
                               light_volume_accum=accum)


def progressive_step_guided(scene: Scene, state: PhotonMapState,
                            config: PipelineConfig,
                            guide: Tensor | None = None,
                            light_index: int = 0, floor: float = 0.25):
    """A progressive tick with self-adaptive guided emission: the wave
    re-emits its sample grid warped by the contribution guide measured from
    the previous wave (``guide``; None for the first, uniform wave) and
    returns the next wave's guide. Adaptivity uses only past waves, so each
    wave is conditionally unbiased. One directional light only.

    Returns (new state, next guide)."""
    light = scene.lights[light_index]
    if light.type != L.DIRECTIONAL:
        raise ValueError("guided progressive refinement supports "
                         "directional lights")
    grid = sampling.stratified_grid_2d(config.photons_x, config.photons_y,
                                       device=scene.device)
    if guide is not None:
        grid = sampling.warp_samples_2d(grid, guide, floor=floor)
    iteration = state.photons.iteration + 1
    ls = emit_mod.emit(light, grid, key=rng.fold_in(state.key, iteration),
                       iteration=iteration)
    new_state = progressive_step(
        scene, dataclasses.replace(state, light_samples=ls), config)
    n_g = config.guide_resolution
    next_guide = emit_mod.emission_guide_from_wave(
        grid[:, 0:2], grid[:, 3], new_state.photons.powers, n_g, n_g)
    return new_state, next_guide


# --- correlated selective recomputation -----------------------------------

@telemetry.spanned("importance.path")
def recompute_importance(config: PipelineConfig,
                         importance_grid: UniformGrid3D,
                         photons: PhotonData,
                         light_samples: LightSamples) -> Tensor:
    """The per-photon importance the correlated step ranks by.

    The grid is first dilated by the tracer's majorant ring: with macrocell
    majorants a trajectory depends on data up to ``block_ring`` cells
    beside its path, so a change one cell away from a path must flag it
    too. Trajectories also depend on the capped empty-space distance map
    up to ``empty_jump_cap + 1`` cells away, so that dilation is an
    approximation; ``config.recompute.exact_coverage`` dilates by the full
    influence radius instead, at the cost of a much fatter flagged set.
    """
    r = config.tracer.block_ring
    if config.recompute.exact_coverage:
        r += config.tracer.empty_jump_cap + 1
    # A (2r+1)^3 running maximum; the pool pads with -inf.
    dilated = F.max_pool3d(importance_grid.data[None, None], 2 * r + 1,
                           stride=1, padding=r)[0, 0]
    grid = dataclasses.replace(importance_grid, data=dilated)
    return path_importance.photon_path_importance(
        grid, photons, light_samples,
        max_steps=config.recompute.importance_steps,
        mode=config.recompute.importance_mode,
        n_samples=config.recompute.importance_quadrature_samples)


def recompute_budget(config: PipelineConfig, n_photons: int) -> int:
    """Retrace batch size: ``max_photons_fraction`` of the photon count,
    rounded up to a multiple of 256."""
    b = int(math.ceil(config.recompute.max_photons_fraction * n_photons))
    return max(256, -(-b // 256) * 256)


@telemetry.spanned("pipeline.selected_samples")
def selected_samples(samples: LightSamples, indices: Tensor,
                     valid: Tensor) -> tuple[LightSamples, Tensor]:
    """The sub-bundle of a retrace batch and its lanes' photon ids: a
    padding lane (``valid`` False) reads light sample 0 and gets the span
    (0, -1), so it never starts."""
    safe = torch.where(valid, indices, 0)
    never = telemetry.wait("step.never_span", torch.tensor, [0.0, -1.0],
                           dtype=torch.float32, device=indices.device)
    sub = LightSamples(
        origins=samples.origins[safe], directions=samples.directions[safe],
        powers=samples.powers[safe],
        tspan=torch.where(valid[:, None], samples.tspan[safe], never),
        iteration=samples.iteration)
    return sub, safe


def _select_and_retrace(scene: Scene, state: PhotonMapState,
                        config: PipelineConfig,
                        importance_grid: UniformGrid3D, budget: int):
    """The first half of a correlated update: path importance -> top-budget
    selection (without the photons already retraced this round) -> retrace
    of the selected light samples under their own random streams -> merge.
    Returns (photons before, photons after, indices, valid, n_remaining ()
    tensor)."""
    # The progressive iteration restarts on any TF/volume change; during a
    # drain it is already 0.
    iteration = 0
    photons = dataclasses.replace(
        state.photons, iteration=iteration,
        radius_rel=f32_scalar(config.tracer.radius_rel))
    if config.recompute.equal_importance:
        # The round-robin phase advances once per call, so coverage rotates
        # across the photon buffer whatever the progressive iteration is.
        imp = path_importance.equal_importance(
            photons.n, state.recompute_phase,
            config.recompute.equal_importance_percentage,
            device=scene.device)
    else:
        imp = recompute_importance(config, importance_grid, photons,
                                   state.light_samples)
    with telemetry.span("importance.select"):
        indices, valid, n_remaining = select.select_photons_to_recompute(
            imp, budget, exclude=state.retraced)

    sub, safe = selected_samples(state.light_samples, indices, valid)
    with telemetry.span("pipeline.retrace"):
        new = _trace(scene, sub, rng.fold_in(state.key, iteration), config,
                     lane_ids=safe)
    new = dataclasses.replace(
        new, radius_rel=photons.radius_rel,
        scene_radius=photons.scene_radius, iteration=iteration)
    merged = tracer.merge_recomputed(photons, new, indices, valid)
    return photons, merged, indices, valid, n_remaining


@telemetry.spanned("pipeline.after_batch")
def _after_batch(state: PhotonMapState, merged: PhotonData, lv: Tensor,
                 indices: Tensor, valid: Tensor,
                 n_remaining: int) -> PhotonMapState:
    """The state after a retrace batch: the batch joins the retraced mask
    while flagged photons remain, and the mask clears with the last one."""
    n = merged.n
    if n_remaining > 0:
        hit = torch.zeros(n + 1, dtype=torch.bool, device=valid.device)
        telemetry.wait("step.retraced_mask", hit.__setitem__,
                       torch.where(valid, indices, n), True)
        retraced = state.retraced | hit[:n]
    else:
        retraced = torch.zeros_like(state.retraced)
    return dataclasses.replace(
        state, photons=merged, light_volume=lv, light_volume_accum=lv,
        retraced=retraced, n_remaining=n_remaining,
        recompute_phase=state.recompute_phase + 1)


@telemetry.spanned("pipeline.correlated_step")
def correlated_step(scene: Scene, state: PhotonMapState,
                    config: PipelineConfig, importance_grid: UniformGrid3D,
                    budget: int) -> PhotonMapState:
    """Selective recomputation: integrate importance along the stored
    photon paths, retrace only the top-``budget`` photons and update the
    light volume incrementally with the -1/+1 splat (one splat of the
    signed list), unless the changed share reaches
    ``config.splat.incremental_threshold``, where a full resplat replaces
    it.

    Drain semantics: photons in ``state.retraced`` are excluded from the
    selection, so a multi-step drain retraces every flagged photon exactly
    once. The step resets the progressive state (iteration 0, the
    configuration's radius, accumulator = corrected volume); :func:`step`
    clears the drain bookkeeping on a fresh invalidation.
    """
    photons, merged, indices, valid, n_remaining = _select_and_retrace(
        scene, state, config, importance_grid, budget)
    dim = light_volume_shape(config)
    fp = splat_footprint(config)
    method = splat_method(config, scene.device)
    threshold = int(config.splat.incremental_threshold * photons.n)
    # n_changed <= budget, so a budget under the threshold rules the full
    # resplat out without asking the device for n_changed.
    if budget < threshold:
        n_remaining = telemetry.wait("step.n_remaining", int, n_remaining)
        full = False
    else:
        n_remaining, n_changed = telemetry.wait(
            "step.n_remaining", torch.Tensor.tolist,
            torch.stack([n_remaining, valid.sum()]))
        full = n_changed >= threshold
    if full:
        lv = splat.splat_all(merged, dim, fp, method=method)
    else:
        lv = state.light_volume + splat.splat_selected_delta(
            photons, merged, indices, valid, dim, fp, method=method)
    return _after_batch(state, merged, lv, indices, valid, n_remaining)


@telemetry.spanned("pipeline.correlated_step_scalable")
def correlated_step_scalable(scene: Scene, state: PhotonMapState,
                             config: PipelineConfig,
                             importance_grid: UniformGrid3D,
                             budget: int) -> PhotonMapState:
    """The correlated update for multi-million-photon maps: the semantics
    of :func:`correlated_step` without the full-resplat threshold, and with
    the removed and the added deposits as two splats of the product kernel,
    each half the signed list's length."""
    photons, merged, indices, valid, n_remaining = _select_and_retrace(
        scene, state, config, importance_grid, budget)
    dim = light_volume_shape(config)
    fp = splat_footprint(config)
    method = splat.default_method(scene.device)
    removed = splat.splat_selected(photons, indices, valid, dim, fp,
                                   method=method)
    added = splat.splat_selected(merged, indices, valid, dim, fp,
                                 method=method)
    lv = state.light_volume - removed + added
    return _after_batch(state, merged, lv, indices, valid, telemetry.wait(
        "step.n_remaining", int, n_remaining))


# --- importance-grid construction -----------------------------------------

@telemetry.spanned("importance.grid")
def build_importance_grid(scene: Scene, config: PipelineConfig,
                          weights: importance_mod.ImportanceWeights | None
                          = None,
                          prev_minmax: Tensor | None = None,
                          volume_diff: Tensor | None = None,
                          screen_space_weight: float = 0.0) -> UniformGrid3D:
    """min/max grid -> TF-classified importance grid. With ``prev_minmax``
    and ``volume_diff`` from the previous time step it is the time-varying
    importance instead. ``screen_space_weight`` w in (0, 1] mixes in the
    camera-visibility term: the importance times (1 - w) + w * vis, so
    cells no camera ray crosses are downweighted by 1 - w."""
    if weights is None:
        weights = importance_mod.ImportanceWeights()
    w = weights.normalized()
    mm = minmax.volume_min_max(scene.volume, config.recompute.grid_cell_size)
    with telemetry.span("importance.classify"):
        if volume_diff is not None and prev_minmax is not None:
            imp = importance_mod.classify_time_varying_importance(
                mm.data, prev_minmax, volume_diff, scene.tf.positions,
                scene.tf.colors, w)
        else:
            imp = importance_mod.classify_importance(
                mm.data, scene.tf.positions, scene.tf.colors, w)
    if screen_space_weight > 0.0:
        vis = screen_importance.cell_visibility_from_camera(
            mm, scene.tf, scene.camera)
        imp = imp * ((1.0 - screen_space_weight)
                     + screen_space_weight * vis)
    return dataclasses.replace(mm, data=imp)


@telemetry.spanned("importance.tf_change_grid")
def build_tf_change_importance_grid(scene: Scene, config: PipelineConfig,
                                    prev_tf_positions,
                                    prev_tf_colors) -> UniformGrid3D:
    """Incremental TF-difference importance: only regions whose appearance
    changed under the TF edit get importance. The merge-walk of the two
    point lists runs on the host, the classification on the device."""
    mm = minmax.volume_min_max(scene.volume, config.recompute.grid_cell_size)

    def host(t):
        if not torch.is_tensor(t):
            return t
        return telemetry.wait("importance.tf_points", torch.Tensor.cpu,
                              t.detach()).numpy()

    def upload(a):
        return telemetry.wait("importance.tf_difference", torch.Tensor.to,
                              torch.from_numpy(a), scene.device)

    with telemetry.span("importance.tf_difference"):
        dpos, dcol = importance_mod.tf_difference_points(
            host(prev_tf_positions), host(prev_tf_colors),
            host(scene.tf.positions), host(scene.tf.colors))
    pos, col = upload(dpos), upload(dcol)
    with telemetry.span("importance.classify"):
        imp = importance_mod.classify_importance(
            mm.data, pos, col, weights=None, incremental=True)
    return dataclasses.replace(mm, data=imp)


# --- rendering and top-level dispatch -------------------------------------

@telemetry.spanned("pipeline.render_state")
def render_state(scene: Scene, state: PhotonMapState,
                 config: PipelineConfig) -> Tensor:
    """Composite the progressive light volume into an (H, W, 4) image with
    the sweep renderer (``render.method="sweep"``, the default) or the
    gather marcher (``"march"``), the sweep's physics oracle, which renders
    any camera."""
    if config.render.method == "sweep":
        return sweep_render.sweep_render(
            scene.volume, scene.tf, state.light_volume_accum, scene.camera,
            config.render)
    if config.render.method == "march":
        return gather.render(scene.volume, scene.tf,
                             state.light_volume_accum, scene.camera,
                             config.render)
    raise ValueError(f"unknown render method {config.render.method!r}")


@telemetry.spanned("pipeline.step")
def step(scene: Scene, state: PhotonMapState, config: PipelineConfig,
         flags: DirtyFlags,
         importance_grid: UniformGrid3D | None = None) -> PhotonMapState:
    """Dispatch one pipeline step on the dirty flags.

    - light/camera dirty, or TF/volume dirty with no importance grid: full
      retrace.
    - TF/volume dirty with an importance grid: correlated update, a fresh
      drain round.
    - progressive only: drain the flagged photons that remain, else a
      refinement tick.
    """
    tf_or_volume = flags.tf or flags.volume
    if flags.light or flags.camera or (importance_grid is None
                                       and tf_or_volume):
        return full_trace_step(scene, state, config)
    if tf_or_volume:
        # A fresh invalidation restarts the drain round: selection against
        # the new importance grid starts from the top priorities.
        state = dataclasses.replace(
            state, retraced=torch.zeros_like(state.retraced), n_remaining=0)
        return correlated_step(scene, state, config, importance_grid,
                               recompute_budget(config, state.photons.n))
    if flags.progressive:
        if importance_grid is not None and state.n_remaining > 0:
            return correlated_step(scene, state, config, importance_grid,
                                   recompute_budget(config, state.photons.n))
        return progressive_step(scene, state, config)
    return state

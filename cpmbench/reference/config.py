"""Frozen configuration dataclasses, field for field those of
``cpm_tpu/core/config.py`` with the same defaults, frozen from the
port's ``core/config.py``.

The port honours every field: the forward frame's (every light type,
both sample orders, guided emission, ``photon_dtype="float16"``,
``no_single_scattering``, both render methods), the progressive tick's
and the correlated update's.
``use_compaction`` and ``brick_scale`` shape only the TPU form of the
trace loop; its results do not depend on them, and the port ignores them.
``recompute.importance_mode="quadrature_mxu"`` (the default) names a
one-hot matrix-product form of the gather quadrature that exists to avoid
TPU gathers and has the same values; the port runs the gather quadrature
for it (``ops/path_importance.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cpmbench.reference import constants
from cpmbench.reference import phase as phase_mod


@dataclass(frozen=True)
class TracerConfig:
    """Photon-tracing stage configuration (see the reference's docs per
    field)."""

    max_interactions: int = 1
    phase_type: int = phase_mod.ISOTROPIC
    phase_g: float = 0.0  # HG anisotropy / Schlick k
    clip_min: tuple = (0.0, 0.0, 0.0)
    clip_max: tuple = (1.0, 1.0, 1.0)
    tau_max: float = 1.0  # safety multiplier on the per-cell majorants
    sampling_rate: float = 2.0
    alpha: float = 0.3  # progressive radius alpha (Knaus-Zwicker)
    max_steps: int = 20000  # hard cap on wavefront iterations
    no_single_scattering: bool = False
    radius_rel: float = constants.DEFAULT_RADIUS_REL
    use_majorant_grid: bool = True  # macrocell empty-space skipping
    photon_dtype: str = "float32"
    trace_chunk: int | None = None
    majorant_cell_size: int = 8  # voxels per majorant macrocell axis
    block_ring: int = 1
    empty_jump_cap: int = 6
    brick_scale: int = 2
    use_compaction: bool = True
    # Woodcock flight attempts per check of the loop condition; results
    # depend on K (the loop only exits between K-groups).
    flights_per_iteration: int = 2


@dataclass(frozen=True)
class SplatConfig:
    """Light-volume splatting configuration."""

    volume_size_from_radius: bool = True  # ceil(1/r_rel) per axis
    volume_dim: int = 64  # used when volume_size_from_radius is False
    footprint: int = 4  # voxels per axis covered per photon (radial splat)
    incremental_threshold: float = 0.6
    # "auto" -> the CUDA product-splat kernel for CUDA tensors, its plain
    # PyTorch version for CPU tensors; "matmul" -> the plain version;
    # "cuda" -> the kernel wrapper; "scatter" -> exact radial scatter-add.
    method: str = "auto"


@dataclass(frozen=True)
class RecomputeConfig:
    """Correlated selective-recomputation configuration.
    ``importance_mode`` is "dda" (exact traversal), "quadrature" or
    "quadrature_mxu" (both the K-sample gather quadrature here)."""

    max_photons_fraction: float = 0.1
    equal_importance: bool = False
    equal_importance_percentage: int = 10
    grid_cell_size: int = constants.DEFAULT_GRID_CELL_SIZE
    importance_steps: int = 64
    importance_mode: str = "quadrature_mxu"
    importance_quadrature_samples: int = 8
    exact_coverage: bool = False


@dataclass(frozen=True)
class RenderConfig:
    """Camera compositing configuration."""

    width: int = 512
    height: int = 512
    sampling_rate: float = 1.0
    ambient: float = 0.05
    # "sweep" -> shear-warp renderer (ops/sweep_render.py); "march" -> the
    # gather marcher (ops/gather.py).
    method: str = "sweep"
    inter_scale: float = 1.5  # intermediate-image oversampling


@dataclass(frozen=True)
class PipelineConfig:
    tracer: TracerConfig = field(default_factory=TracerConfig)
    splat: SplatConfig = field(default_factory=SplatConfig)
    recompute: RecomputeConfig = field(default_factory=RecomputeConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    photons_x: int = 256  # photon grid (photons = photons_x * photons_y)
    photons_y: int = 256
    guided_emission: bool = False
    guide_resolution: int = 64
    guide_floor: float = 0.1
    sample_order: str = "linear"

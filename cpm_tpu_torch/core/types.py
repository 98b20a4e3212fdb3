"""Core data structures of the port: dataclasses of tensors, one per
container of ``cpm_tpu/core/types.py``.

Scalars that the host needs to read (photon radius, scene radius,
iteration counters) are Python numbers holding float32 values, so no
step waits on the device to learn them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from cpm_tpu_torch.core import constants, telemetry
from cpm_tpu_torch.core.device import resolve

Tensor = torch.Tensor
F32 = torch.float32


def f32_scalar(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


def full_fp32_matmul() -> None:
    """Keep float32 matrix products in full float32 on the card: TF32
    keeps ~3 decimal digits, the reference's products are fp32-accurate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class Volume:
    """A scalar volume in [0, 1], stored [z, y, x] with x fastest, with a
    texture-space ([0,1]^3) to world transform ``w = basis @ t + offset``."""

    data: Tensor  # (D, H, W) float32
    basis: Tensor  # (3, 3) float32
    offset: Tensor  # (3,) float32

    @property
    def shape_zyx(self):
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def scene_radius(self) -> float:
        """0.5 * |(|b0|, |b1|, |b2|)| in float32 (the reference's
        getSceneRadius)."""
        basis = telemetry.wait("volume.scene_radius", self.basis.detach().to,
                               "cpu", F32)
        ext = torch.linalg.vector_norm(basis, dim=0)
        return float(0.5 * torch.linalg.vector_norm(ext))

    @classmethod
    def from_data(cls, data, basis=None, offset=None, device=None) -> "Volume":
        if basis is None:
            basis = np.eye(3, dtype=np.float32) * 2.0
        if offset is None:
            offset = np.array([-1.0, -1.0, -1.0], np.float32)
        data = torch.as_tensor(data, dtype=F32, device=resolve(device))
        return cls(data=data.contiguous(),
                   basis=torch.as_tensor(basis, dtype=F32, device=data.device),
                   offset=torch.as_tensor(offset, dtype=F32,
                                          device=data.device))


def clip(x: Tensor, lo: float | None = None,
         hi: float | None = None) -> Tensor:
    """``torch.clamp(x, lo, hi)`` whose gradient at a bound is halved, as
    ``jnp.clip``'s and ``jnp.maximum``'s are (ties split the gradient), so
    gradients match the reference's where a value sits exactly on a bound
    (a volume's zeros on a TF's first point). Without a graph it is the
    one clamp: the tie-splitting form dispatches four operators for it
    (two 0-dim fills, ``maximum``, ``minimum``), each a launch on a card,
    and ``sample_opacity`` runs it once per TF segment, twice a flight in
    the host-bound trace loop (63 operators a call instead of 54 at the
    default 4-point TF)."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp`` in torch: piecewise-linear with edge clamping."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _float32(x, device) -> Tensor:
    """``x`` as a float32 tensor on ``device``: a tensor through ``.to``
    (its autograd graph survives), anything else through numpy."""
    if isinstance(x, Tensor):
        return x.to(device, F32)
    return telemetry.wait("types.float32", torch.as_tensor,
                          np.asarray(x, np.float32), device=device)


@dataclass
class TransferFunction:
    """Piecewise-linear RGBA transfer function: the point list and the baked
    LUT. ``colors[..., 3]`` is opacity; extinction = opacity *
    SAMPLING_BASE_INTERVAL_RCP."""

    positions: Tensor  # (P,) float32 ascending in [0, 1]
    colors: Tensor  # (P, 4) float32 RGBA
    lut: Tensor  # (K, 4) float32, baked

    @classmethod
    @telemetry.spanned("scene.transfer_function")
    def from_points(cls, positions, colors, lut_size: int = 256,
                    device=None) -> "TransferFunction":
        """Tensors are moved, not copied through numpy, so a point list
        that requires grad keeps its graph (an inverse-rendering fit
        differentiates through ``from_points``)."""
        positions = _float32(positions, resolve(device))
        colors = _float32(colors, positions.device)
        x = (torch.arange(lut_size, dtype=F32, device=positions.device)
             + 0.5) / lut_size
        lut = torch.stack([interp(x, positions, colors[:, c])
                           for c in range(colors.shape[1])], dim=-1)
        return cls(positions=positions, colors=colors, lut=lut)

    def sample(self, x: Tensor) -> Tensor:
        """Exact piecewise-linear evaluation from the point list, edge
        colours clamped (``cpm_tpu/core/types.py:100-122``)."""
        p, c = self.positions, self.colors
        acc = c[0].expand(x.shape + (c.shape[-1],))
        for s in range(p.shape[0] - 1):
            t = (x - p[s]) / torch.clamp(p[s + 1] - p[s], min=1e-12)
            t = clip(t, 0.0, 1.0)
            seg = c[s] + (c[s + 1] - c[s]) * t[..., None]
            acc = torch.where((x >= p[s])[..., None], seg, acc)
        return acc

    def sample_opacity(self, x: Tensor) -> Tensor:
        """Opacity channel only (``cpm_tpu/core/types.py:124-139``)."""
        return piecewise_opacity(self.positions, self.colors[:, 3], x)


def piecewise_opacity(p: Tensor, c: Tensor, x: Tensor) -> Tensor:
    """The piecewise-linear opacity of the point list (positions ``p``,
    opacities ``c``) at ``x``, edge values clamped: segment after segment,
    each where ``x >= p[s]``."""
    acc = c[0].expand(x.shape)
    for s in range(p.shape[0] - 1):
        t = (x - p[s]) / torch.clamp(p[s + 1] - p[s], min=1e-12)
        t = clip(t, 0.0, 1.0)
        seg = c[s] + (c[s + 1] - c[s]) * t
        acc = torch.where(x >= p[s], seg, acc)
    return acc


@dataclass
class LightSamples:
    """Per-light-sample ray bundle; a miss has tspan = (0, -1)."""

    origins: Tensor  # (N, 3) texture space
    directions: Tensor  # (N, 3) normalized
    powers: Tensor  # (N, 3)
    tspan: Tensor  # (N, 2) [tStart, tEnd]
    iteration: int = 0

    @property
    def n(self) -> int:
        return self.origins.shape[0]


@dataclass
class PhotonData:
    """SoA photon storage, interaction-major: slot [i, t] holds the photon
    deposited by light sample ``t`` at its ``i``-th interaction. Unused
    slots hold FLT_MAX positions; ``exit_power`` is FLT_MAX after an
    absorption."""

    positions: Tensor  # (I, N, 3) texture space; FLT_MAX when unused
    powers: Tensor  # (I, N, 3)
    directions: Tensor  # (I, N, 2) encoded (theta, phi)
    exit_power: Tensor  # (N,)
    exit_direction: Tensor  # (N, 2)
    radius_rel: float  # float32 value
    scene_radius: float  # float32 value
    iteration: int = 0

    @property
    def max_interactions(self) -> int:
        return self.positions.shape[0]

    @property
    def n(self) -> int:
        return self.positions.shape[1]

    @classmethod
    def create(cls, n: int, max_interactions: int = 1,
               radius_rel: float = constants.DEFAULT_RADIUS_REL,
               scene_radius: float = constants.DEFAULT_SCENE_RADIUS,
               device=None) -> "PhotonData":
        big = float(constants.FLT_MAX)
        kw = dict(dtype=F32, device=resolve(device))
        return cls(
            positions=torch.full((max_interactions, n, 3), big, **kw),
            powers=torch.zeros((max_interactions, n, 3), **kw),
            directions=torch.zeros((max_interactions, n, 2), **kw),
            exit_power=torch.full((n,), big, **kw),
            exit_direction=torch.zeros((n, 2), **kw),
            radius_rel=f32_scalar(radius_rel),
            scene_radius=f32_scalar(scene_radius),
            iteration=0,
        )


@dataclass
class UniformGrid3D:
    """Uniform grid over a volume: ``data`` is [z, y, x(, c)], cells of
    ``cell_dim`` voxels."""

    data: Tensor
    cell_dim: Tensor  # (3,) float32, cell size in voxels (x, y, z)
    volume_dim: Tensor  # (3,) float32, voxels of the source volume (x, y, z)


def progressive_sphere_radius(radius: float, iteration: int,
                              alpha: float) -> float:
    """Knaus-Zwicker progressive radius in float32:
    r_{i+1} = r_i ((i + a) / (i + 1))^(1/3)."""
    it = np.float32(iteration)
    ratio = (it + np.float32(alpha)) / (np.float32(1.0) + it)
    return float(np.float32(radius)
                 * np.power(ratio, np.float32(1.0 / 3.0)))


def sphere_volume(radius) -> np.float32:
    r = np.float32(radius)
    return r * r * r * np.float32(math.pi * 4.0 / 3.0)


def relative_irradiance_scale(n_photons, radius_rel) -> float:
    """Splat scale = (1/pi) / (photonVolume * nPhotons), in float32."""
    return float(np.float32(constants.SCALE_LIGHT_POWER_DIRECTIONAL)
                 / (sphere_volume(radius_rel) * np.float32(n_photons)))


def encode_direction(d: Tensor) -> Tensor:
    """Direction -> (theta, phi) spherical packing."""
    phi = torch.atan2(d[..., 1], d[..., 0])
    theta = torch.acos(torch.clamp(d[..., 2], -1.0, 1.0))
    return torch.stack([theta, phi], dim=-1)


def decode_direction(angles: Tensor) -> Tensor:
    """(theta, phi) -> unit direction, the inverse of
    :func:`encode_direction`."""
    theta, phi = angles[..., 0], angles[..., 1]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct],
                       dim=-1)

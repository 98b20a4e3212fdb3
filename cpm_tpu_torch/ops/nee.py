"""Next-event estimation: sample a light toward query points
(``cpm_tpu/ops/nee.py``, after the readable per-type branches of the
reference's ``sampleLightSource``, lightsampling.cl:59-140).

- point: power = radiance / |p - o|^2, pdf = 1;
- cone: the same, zero outside the cone's aperture;
- area: a uniform point of the quad; pdf = dist^2 / (cos_l * area), zero
  where the quad faces away;
- directional: the fixed direction, power = radiance, pdf = 1.

One call evaluates every query point against one light; the light type
picks the branch on the host. With :func:`gather.transmittance_to_point`
it gives a single-scattering estimate (:func:`nee_single_scatter`).
"""

from __future__ import annotations

import torch

from cpm_tpu_torch.core import lights as L
from cpm_tpu_torch.core.types import f32_scalar
from cpm_tpu_torch.ops import rng
from cpm_tpu_torch.ops.gather import transmittance_to_point

Tensor = torch.Tensor


def _vec(v, like: Tensor) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def sample_light_toward(light: L.Light, positions: Tensor,
                        key: tuple | None = None):
    """Sample ``light`` toward each of the (N, 3) texture-space
    ``positions``. ``key`` ((k0, k1)) draws an area light's point on the
    quad (``jax.random.uniform``'s words); without it the quad's centre.

    Returns (wi, radiance, pdf, origin): (N, 3) unit directions light ->
    point, (N, 3) incident radiance before transmittance, (N,) pdf and
    (N, 3) the sampled light origins."""
    n = positions.shape[0]
    rad = _vec(light.radiance, positions)
    pos_l = _vec(light.position, positions)
    dir_l = _vec(light.direction, positions)
    ones = torch.ones(n, dtype=torch.float32, device=positions.device)

    if light.type == L.DIRECTIONAL:
        wi = dir_l.expand(n, 3)
        # Pushed far back along -wi: the transmittance ray crosses the
        # whole volume.
        return wi, rad.expand(n, 3), ones, positions - 10.0 * wi

    if light.type in (L.POINT, L.CONE):
        delta = positions - pos_l
        dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-12)
        wi = delta / torch.sqrt(dist2)[:, None]
        power = rad[None, :] / dist2[:, None]
        pdf = ones
        if light.type == L.CONE:
            inside = (torch.sum(wi * dir_l[None, :], dim=-1)
                      >= f32_scalar(light.cos_fov))
            power = torch.where(inside[:, None], power, 0.0)
            pdf = torch.where(inside, pdf, 0.0)
        return wi, power, pdf, pos_l.expand(n, 3)

    if light.type == L.AREA:
        if key is None:
            uv = torch.full((n, 2), 0.5, device=positions.device)
        else:
            uv = rng.uniform(key, (n, 2), positions.device)
        # Orthonormal frame around the area normal.
        nrm = dir_l / torch.linalg.vector_norm(dir_l)
        up = torch.where(torch.abs(nrm[2]) < 0.9,
                         _vec((0.0, 0.0, 1.0), positions),
                         _vec((1.0, 0.0, 0.0), positions))
        t1 = torch.linalg.cross(up, nrm)
        t1 = t1 / torch.linalg.vector_norm(t1)
        t2 = torch.linalg.cross(nrm, t1)
        size = _vec(light.size, positions)
        origin = (pos_l[None, :]
                  + (uv[:, :1] - 0.5) * size[0] * t1[None, :]
                  + (uv[:, 1:] - 0.5) * size[1] * t2[None, :])
        delta = positions - origin
        dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-12)
        wi = delta / torch.sqrt(dist2)[:, None]
        cos_l = torch.sum(wi * nrm[None, :], dim=-1)
        facing = cos_l > 0.0
        pdf = torch.where(facing, dist2 / torch.clamp(
            cos_l * (size[0] * size[1]), min=1e-12), 0.0)
        power = torch.where(facing[:, None], rad[None, :], 0.0)
        return wi, power, pdf, origin

    raise ValueError(f"unknown light type {light.type}")


def nee_single_scatter(light: L.Light, volume, tf, positions: Tensor,
                       key: tuple | None = None,
                       n_steps: int = 64) -> Tensor:
    """Transmittance-weighted NEE estimate of the direct in-scattered
    radiance at each position, T(origin -> p) * power / max(pdf, 1e-12),
    (N, 3). The phase function's factor is the caller's."""
    _, power, pdf, origin = sample_light_toward(light, positions, key)
    trans = transmittance_to_point(volume, tf, origin, positions,
                                   n_steps=n_steps)
    return power * (trans / torch.clamp(pdf, min=1e-12))[:, None]

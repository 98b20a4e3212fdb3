"""Differentiable replay of the photon power chain from stored paths
(``cpm_tpu/ops/replay.py``).

The tracer's sampling decisions are discrete and it records no graph, so
the gradient takes the trajectories as fixed samples (detached sampling)
and recomputes every factor of the deposited power as a differentiable
function of the scene (photontracer.cl:158-197):

    power_in_i = p_{i-1} / max(opacity(x_i), 0.01)
    deposit_i  = power_in_i * albedo_i  if the photon scattered at x_i
               = power_in_i             if it was absorbed there
    p_i        = power_in_i * albedo_i
    albedo_i   = scat.w / (scat.w + color.w)

Every interaction but a lane's last one scattered; the last one scattered
unless the lane was absorbed (``exit_power`` at FLT_MAX). At the primal
point the replayed powers equal the traced ones to rounding.

``no_single_scattering`` traces are not replayable: their first event,
which divides the power by the phase pdf, stores no position.
"""

from __future__ import annotations

import dataclasses

import torch

from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      TransferFunction, Volume, clip)
from cpm_tpu_torch.ops.sampling import sample_volume_trilinear

Tensor = torch.Tensor


def replay_powers(volume: Volume, tf: TransferFunction,
                  tf_scattering: TransferFunction, photons: PhotonData,
                  light_samples: LightSamples,
                  no_single_scattering: bool = False) -> Tensor:
    """The (I, N, 3) deposited powers, differentiable with respect to
    ``volume.data``, both TFs' points and ``light_samples.powers``.
    Positions and ``exit_power`` are detached; unused slots (position
    >= 1e30, in float32 whatever the storage type) give 0.

    Pass the tracer's ``no_single_scattering`` flag: such traces raise."""
    if no_single_scattering:
        raise NotImplementedError(
            "replay_powers cannot reconstruct the power chain of "
            "no_single_scattering traces: the first event's position (and "
            "hence its opacity/albedo factors) is not stored in the photon "
            "map (photontracer.cl:143-157 under -D NO_SINGLE_SCATTERING)")
    max_i = photons.max_interactions
    pos = photons.positions.detach().to(torch.float32)  # (I, N, 3)
    valid = pos[..., 0] < 1e30  # (I, N)
    last = valid.sum(0) - 1  # (N,) the lane's last interaction
    absorbed = photons.exit_power.detach() >= 1e30  # (N,)

    f = sample_volume_trilinear(volume.data,
                                torch.where(valid[..., None], pos, 0.5))
    opacity = tf.sample_opacity(f)
    scat_w = tf_scattering.sample_opacity(f)
    albedo = scat_w / clip(scat_w + opacity, 1e-8)
    inv_op = 1.0 / clip(opacity, 0.01)

    idx = torch.arange(max_i, device=pos.device)[:, None]  # (I, 1)
    scattered = valid & ((idx != last[None, :]) | ~absorbed[None, :])
    # What interaction i multiplies the running power by: its deposit's
    # factor, and the factor the power carries on to i + 1.
    mult = torch.where(valid, inv_op * torch.where(scattered, albedo, 1.0),
                       1.0)  # (I, N)
    # The running power before interaction i is p0 * prod_{j<i} mult_j: a
    # product written out over the few interactions, whose backward needs
    # no division by a factor that may be 0.
    running = [torch.ones_like(mult[0])]
    for i in range(max_i - 1):
        running.append(running[-1] * mult[i])
    p0 = light_samples.powers / float(max_i)  # (N, 3)
    powers = p0[None] * (torch.stack(running) * mult)[..., None]
    return torch.where(valid[..., None], powers, 0.0)


def replay_photons(volume: Volume, tf: TransferFunction,
                   tf_scattering: TransferFunction, photons: PhotonData,
                   light_samples: LightSamples,
                   no_single_scattering: bool = False) -> PhotonData:
    """``photons`` with their powers replaced by the differentiable
    replay."""
    return dataclasses.replace(photons, powers=replay_powers(
        volume, tf, tf_scattering, photons, light_samples,
        no_single_scattering=no_single_scattering))

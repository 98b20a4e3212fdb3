"""Score-function trajectory gradients for the photon tracer
(``cpm_tpu/ops/score_grad.py``).

The replay (``ops/replay.py``) differentiates every factor of the
deposited power but holds the trajectories fixed, so it misses how the
flight, acceptance and scatter decisions move with the scene. The
score-function (likelihood-ratio) estimator over the tracer's event tape
(``ops/tracer.py:TraceEvents``) adds those terms:

    d/dθ E[L] = E[ dL/dθ |pathwise  +  L_lane · d/dθ log p_θ(trajectory) ]

With the recorded majorant held fixed (delta tracking is unbiased for any
majorant bound), the θ-dependent factors of a trajectory's probability
are:

    null collision at x:      1 - σ(x)/σ̄
    accepted collision at x:  σ(x)/σ̄
    scattered:                albedo(x)
    absorbed by the test:     1 - albedo(x)
    forced stop, first event: the acceptance factor only

with σ the TF opacity of the trilinear volume fetch and albedo =
scat / (scat + σ). Lanes whose tape overflowed its cap are left out of the
score term (their pathwise term remains); ``no_single_scattering`` traces
are not supported (as in the replay).
"""

from __future__ import annotations

import dataclasses

import torch

from cpm_tpu_torch.core.types import (LightSamples, PhotonData,
                                      TransferFunction, Volume, clip)
from cpm_tpu_torch.ops.replay import replay_powers
from cpm_tpu_torch.ops.sampling import sample_volume_trilinear
from cpm_tpu_torch.ops.tracer import (EVT_ABSORB, EVT_NULL, EVT_SCATTER,
                                      TraceEvents)

Tensor = torch.Tensor

_EPS = 1e-7

# The leaves trajectory_gradients differentiates, by the reference's field
# paths: those on which the estimator's gradient can be nonzero.
GRAD_LEAVES = ("volume.data", "tf.positions", "tf.colors",
               "tf_scattering.positions", "tf_scattering.colors",
               "light_samples.powers")


def log_prob_lanes(events: TraceEvents, volume: Volume, tf: TransferFunction,
                   tf_scattering: TransferFunction) -> Tensor:
    """(N,) log-probability of each lane's recorded trajectory,
    differentiable with respect to the scene (positions and majorants
    fixed). A lane whose tape overflowed (counts > E) gives 0."""
    pos = events.positions.detach()  # (N, E, 3)
    maj = events.majorants.detach()
    e = maj.shape[1]
    counts = events.counts
    valid = (torch.arange(e, device=pos.device)[None, :]
             < torch.clamp(counts, max=e)[:, None])

    f = sample_volume_trilinear(volume.data, pos)  # (N, E)
    op = tf.sample_opacity(f)
    scat = tf_scattering.sample_opacity(f)
    albedo = clip(scat / clip(scat + op, 1e-8), _EPS, 1.0 - _EPS)
    ratio = clip(op / torch.clamp(maj, min=1e-12), _EPS, 1.0 - _EPS)

    t = events.types
    term = torch.where(
        t == EVT_NULL, torch.log1p(-ratio),
        torch.log(ratio) + torch.where(
            t == EVT_SCATTER, torch.log(albedo),
            torch.where(t == EVT_ABSORB, torch.log1p(-albedo), 0.0)))
    lp = torch.where(valid, term, 0.0).sum(1)
    return torch.where(counts <= e, lp, 0.0)


def make_surrogate(volume: Volume, tf: TransferFunction,
                   tf_scattering: TransferFunction,
                   light_samples: LightSamples, photons: PhotonData,
                   events: TraceEvents, loss_from_deposits,
                   loss_takes_scene: bool = False):
    """``surrogate(volume, tf, tf_scattering, light_samples)``, whose
    gradient is the full (pathwise + trajectory) estimator of
    ``E[loss_from_deposits(replayed deposits)]``.

    ``loss_from_deposits`` maps the (I, N, 3) deposit powers to a scalar
    tensor. With ``loss_takes_scene`` it is called as
    ``loss(dep, volume, tf, tf_scattering, light_samples)``, so the
    scene's direct part in the loss (the render's TF) flows too. The lane
    weights λ_lane = Σ_i (∂L/∂d_i) · d_i are taken once, at the scene
    given here (the first-order REINFORCE surrogate)."""
    if loss_takes_scene:
        loss_fn = loss_from_deposits
    else:
        def loss_fn(dep, *scene):
            return loss_from_deposits(dep)

    with torch.no_grad():
        dep0 = replay_powers(volume, tf, tf_scattering, photons,
                             light_samples)
    dep0.requires_grad_(True)
    with torch.enable_grad():
        cot, = torch.autograd.grad(
            loss_fn(dep0, volume, tf, tf_scattering, light_samples), dep0)
    w_lane = (cot * dep0.detach()).sum(dim=(0, 2))  # (N,)

    def surrogate(volume_, tf_, tf_scattering_, light_samples_):
        dep = replay_powers(volume_, tf_, tf_scattering_, photons,
                            light_samples_)
        lp = log_prob_lanes(events, volume_, tf_, tf_scattering_)
        return (loss_fn(dep, volume_, tf_, tf_scattering_, light_samples_)
                + (w_lane * lp).sum())

    return surrogate


def _leaf(t: Tensor) -> Tensor:
    return t.detach().requires_grad_(True)


def trajectory_gradients(volume: Volume, tf: TransferFunction,
                         tf_scattering: TransferFunction,
                         light_samples: LightSamples, photons: PhotonData,
                         events: TraceEvents, loss_from_deposits):
    """The full gradient estimator of E[loss_from_deposits(deposits)]:
    (loss value, {leaf path: gradient}) over :data:`GRAD_LEAVES`, each
    gradient shaped as its leaf (zeros where the loss does not reach
    it)."""
    sur = make_surrogate(volume, tf, tf_scattering, light_samples, photons,
                         events, loss_from_deposits)
    v = dataclasses.replace(volume, data=_leaf(volume.data))
    t = dataclasses.replace(tf, positions=_leaf(tf.positions),
                            colors=_leaf(tf.colors))
    s = dataclasses.replace(tf_scattering,
                            positions=_leaf(tf_scattering.positions),
                            colors=_leaf(tf_scattering.colors))
    ls = dataclasses.replace(light_samples,
                             powers=_leaf(light_samples.powers))
    leaves = (v.data, t.positions, t.colors, s.positions, s.colors,
              ls.powers)
    with torch.enable_grad():
        grads = torch.autograd.grad(sur(v, t, s, ls), leaves,
                                    allow_unused=True)
    with torch.no_grad():
        val = loss_from_deposits(replay_powers(
            volume, tf, tf_scattering, photons, light_samples))
    return val, {name: torch.zeros_like(leaf) if g is None else g
                 for name, leaf, g in zip(GRAD_LEAVES, leaves, grads)}

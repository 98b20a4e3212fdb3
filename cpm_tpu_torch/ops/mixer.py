"""Interpolation for time-varying playback (``cpm_tpu/ops/mixer.py``): the
lerp of two volumes, and a sequence sampled at a fractional time with
cyclic indexing."""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def mix(a: Tensor, b: Tensor, x: float) -> Tensor:
    """a * (1 - x) + b * x elementwise in float32, in ``a``'s dtype."""
    xf = np.float32(x)
    return (a.to(torch.float32) * float(np.float32(1.0) - xf)
            + b.to(torch.float32) * float(xf)).to(a.dtype)


def sequence_sample(sequence: Tensor, time: float) -> Tensor:
    """The (T, ...) sequence at fractional ``time``: the lerp of elements
    floor(time) mod T and floor(time) + 1 mod T; at an integer time,
    element time mod T exactly."""
    t = sequence.shape[0]
    tf = np.float32(time)
    lo = math.floor(tf)
    i0 = lo % t
    return mix(sequence[i0], sequence[(i0 + 1) % t], tf - np.float32(lo))

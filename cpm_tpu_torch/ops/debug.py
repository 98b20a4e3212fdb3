"""Debug views (``cpm_tpu/ops/debug.py``): the light-sample distribution
as an image, after the reference's ``SamplesToImageProcessor``, so sample
generators and warps can be inspected."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def samples_to_image(samples: Tensor, width: int = 256, height: int = 256,
                     normalize: bool = True) -> Tensor:
    """Histogram (N, >= 2) [u, v, ...] samples into an (H, W) image.

    Each sample weighs its pdf column where there is one (column 3, the
    reference's float4 layout), else 1. ``normalize`` scales the image so
    that a uniform distribution is 1 everywhere."""
    u = torch.clamp(samples[:, 0], 0.0, 1.0 - 1e-7)
    v = torch.clamp(samples[:, 1], 0.0, 1.0 - 1e-7)
    w = (samples[:, 3] if samples.shape[1] > 3
         else torch.ones_like(samples[:, 0]))
    ix = (u * width).to(torch.int64)
    iy = (v * height).to(torch.int64)
    flat = torch.zeros(height * width, dtype=torch.float32,
                       device=samples.device)
    flat.index_add_(0, iy * width + ix, w.to(torch.float32))
    img = flat.reshape(height, width)
    if normalize:
        img = img * (width * height / torch.clamp(img.sum(), min=1e-12))
    return img

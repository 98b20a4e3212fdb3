"""Selective-recomputation photon selection: threshold + count + sort +
budget (``cpm_tpu/ops/select.py``).

One stable descending sort of the float importances gives the priority
order; the budget is a fixed buffer size B with a validity mask, and the
photons already retraced in this drain round are kept out by an explicit
``exclude`` mask carried in the pipeline state.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def select_photons_to_recompute(importance: Tensor, budget: int,
                                exclude: Tensor | None = None,
                                spatial_sort: bool = True):
    """Pick the top-``budget`` photons by importance.

    ``importance`` is (N,) float (0 = no recompute needed); ``exclude`` an
    optional (N,) bool of photons already retraced this round, whose
    importance counts as 0 so a multi-batch drain visits each photon at
    most once; ``spatial_sort`` re-sorts the selected ids ascending so the
    retrace batch is memory-coherent (light-sample order approximates
    spatial order on the emission plane), padding lanes last.

    Returns (indices (B,) int64, valid (B,) bool, n_remaining () int64):
    the ids to retrace, their validity mask, and how many flagged photons
    remain after this batch. Ties resolve lowest index first.
    """
    n = importance.shape[0]
    dev = importance.device
    if exclude is not None:
        importance = torch.where(exclude, 0.0, importance)
    n_flagged = (importance > 0.0).sum()
    sorted_idx = torch.sort(-importance, stable=True).indices
    ranks = torch.arange(budget, dtype=torch.int64, device=dev)
    indices = sorted_idx[torch.clamp(ranks, max=n - 1)]
    valid = ranks < n_flagged
    if spatial_sort:
        # Padding lanes sort to the end (key = n).
        perm = torch.sort(torch.where(valid, indices, n), stable=True).indices
        indices = indices[perm]
        valid = valid[perm]
    n_remaining = torch.clamp(n_flagged - budget, min=0)
    return indices, valid, n_remaining

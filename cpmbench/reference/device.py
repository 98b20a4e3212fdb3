"""Where the reference makes its tensors: on the CUDA card, unless the
caller names another device."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` is the CUDA card; anything else is taken as given
    (``"cpu"``, ``"cuda:1"``, a ``torch.device``). It does not look
    whether a card is there and never falls back: without one, making a
    tensor on the resolved device fails with torch's own error."""
    return torch.device("cuda" if device is None else device)

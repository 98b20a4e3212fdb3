"""The port's top-budget photon selection against the JAX reference on the
same numpy importances: indices, validity mask and remaining count equal
bit for bit, ties and zeros included (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.ops import select as jselect
from cpm_tpu_torch.ops import select as tselect


def _importance(kind: str, n: int, seed: int) -> np.ndarray:
    """Seeded importances: few distinct values (many ties), mostly zeros,
    continuous, all zero, or all equal."""
    rs = np.random.default_rng(seed)
    if kind == "ties":
        return rs.integers(0, 4, n).astype(np.float32) * np.float32(0.25)
    if kind == "sparse":
        imp = rs.random(n, dtype=np.float32)
        imp[rs.random(n) < 0.8] = 0.0
        return imp
    if kind == "continuous":
        return rs.random(n, dtype=np.float32) + np.float32(1e-3)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    return np.ones(n, np.float32)


def _both(imp, budget, exclude, spatial_sort):
    want = jselect.select_photons_to_recompute(
        jnp.asarray(imp), budget,
        exclude=None if exclude is None else jnp.asarray(exclude),
        spatial_sort=spatial_sort)
    got = tselect.select_photons_to_recompute(
        torch.from_numpy(imp), budget,
        exclude=None if exclude is None else torch.from_numpy(exclude),
        spatial_sort=spatial_sort)
    return got, want


@pytest.mark.parametrize("spatial_sort", [True, False])
@pytest.mark.parametrize("with_exclude", [False, True])
@pytest.mark.parametrize("budget", [64, 512, 1500])
@pytest.mark.parametrize("kind", ["ties", "sparse", "continuous", "zeros",
                                  "ones"])
def test_selection_is_bit_equal(kind, budget, with_exclude, spatial_sort):
    """n = 1000: budgets below and above the flagged count, and one above
    n, whose tail ranks clamp to the last sorted entry."""
    n = 1000
    imp = _importance(kind, n, seed=budget)
    exclude = (np.random.default_rng(3).random(n) < 0.3
               if with_exclude else None)
    (idx, valid, rem), (jidx, jvalid, jrem) = _both(imp, budget, exclude,
                                                    spatial_sort)
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    assert tuple(idx.shape) == tuple(valid.shape) == (budget,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert int(rem) == int(jrem)

    eff = imp if exclude is None else np.where(exclude, 0.0, imp)
    flagged = int((eff > 0).sum())
    assert int(valid.sum()) == min(flagged, budget)
    assert int(rem) == max(flagged - budget, 0)
    sel = idx.numpy()[valid.numpy()]
    assert len(set(sel.tolist())) == len(sel)
    assert np.all(eff[sel] > 0)
    if spatial_sort:
        assert np.all(np.diff(sel) > 0)
        assert np.all(valid.numpy()[:len(sel)])  # padding lanes come last


def test_selection_semantics():
    """The reference's own cases (tests/test_importance.py:190-224)."""
    imp = torch.tensor([0.0, 5.0, 1.0, 0.0, 3.0, 2.0, 0.0, 4.0])
    idx, valid, rem = tselect.select_photons_to_recompute(
        imp, budget=3, spatial_sort=False)
    assert idx[valid].tolist() == [1, 7, 4] and int(rem) == 2
    idx, valid, _ = tselect.select_photons_to_recompute(imp, budget=3)
    assert idx[valid].tolist() == [1, 4, 7]
    done = torch.tensor([False, True, False, False, True, False, False, True])
    idx, valid, rem = tselect.select_photons_to_recompute(
        imp, budget=3, exclude=done, spatial_sort=False)
    assert idx[valid].tolist() == [5, 2] and int(rem) == 0
    # Ties resolve lowest index first.
    idx, valid, rem = tselect.select_photons_to_recompute(
        torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0]), budget=2,
        spatial_sort=False)
    assert idx.tolist() == [0, 2] and bool(valid.all()) and int(rem) == 2

"""The port's debug image (``ops/debug.samples_to_image``) against the
JAX reference, and the reference's checks (tests/test_misc_parity.py
:78-96) on the port (CPU, up to 48^2 samples, 16^2 images)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpm_tpu.ops import debug as jdebug
from cpm_tpu_torch.ops import debug, sampling

# Histogram sums of float32 weights: the order of the additions differs.
RTOL = 1e-5


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("columns", [2, 4])
def test_samples_to_image_matches(columns, normalize):
    rs = np.random.default_rng(3)
    s = rs.uniform(-0.05, 1.05, (2304, 4)).astype(np.float32)
    s[:, 3] = rs.uniform(0.2, 3.0, 2304)
    s[:5, :2] = [[0.0, 0.0], [1.0, 1.0], [1.0 - 1e-8, 0.5], [0.5, 1.0],
                 [0.999999, 0.0]]
    s = s[:, :columns].copy()
    want = np.asarray(jdebug.samples_to_image(jnp.asarray(s), 16, 12,
                                              normalize=normalize))
    got = debug.samples_to_image(torch.from_numpy(s), 16, 12,
                                 normalize=normalize)
    assert got.shape == (12, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_uniform_grid_is_flat():
    s = sampling.stratified_grid_2d(32, 32, device="cpu")
    img = debug.samples_to_image(s, width=16, height=16)
    np.testing.assert_allclose(img.numpy(), 1.0, rtol=1e-5)


def test_pdf_weighting():
    s = torch.tensor([[0.1, 0.1, 0.0, 3.0], [0.9, 0.9, 0.0, 1.0]])
    img = debug.samples_to_image(s, 4, 4, normalize=False).numpy()
    assert img[0, 0] == 3.0 and img[3, 3] == 1.0 and img.sum() == 4.0

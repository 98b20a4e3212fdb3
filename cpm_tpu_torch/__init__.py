"""cpm_tpu_torch: the PyTorch/CUDA port of ``cpm_tpu`` for NVIDIA Hopper.

Same sub-package layout and function names as ``cpm_tpu`` so each
counterpart is easy to find. Plain tensor code is PyTorch; the one
hand-written kernel (the product-Epanechnikov photon splat) lives in
``kernels/`` with its CUDA source in ``csrc/``.

The port imports nothing of JAX and nothing of ``cpm_tpu``: it keeps its
own copies of the reference's numpy-only host modules (``core/constants``,
``core/lights``, ``io/synthetic``, ``ops/lightplane``), and the tests hold
each copy against its original.

Tensors are made on the CUDA card unless the caller names another device
(``device="cpu"``, as the tests do); see ``core/device.py``.
"""

__version__ = "0.1.0"

"""cpm_tpu_torch: the PyTorch/CUDA port of ``cpm_tpu`` for NVIDIA Hopper.

Same sub-package layout and function names as ``cpm_tpu`` so each
counterpart is easy to find. Plain tensor code is PyTorch; the one
hand-written kernel (the product-Epanechnikov photon splat) lives in
``kernels/`` with its CUDA source in ``csrc/``.

The port imports nothing of JAX. Of ``cpm_tpu`` it imports only four
numpy-only modules, which it shares with the reference:
``cpm_tpu.core.constants``, ``cpm_tpu.core.lights``,
``cpm_tpu.io.synthetic`` and ``cpm_tpu.ops.lightplane``.
"""

__version__ = "0.1.0"

"""The product-Epanechnikov photon splat: the Hopper kernel
(``csrc/splat_product.cu``), its wrapper and its plain PyTorch version.

It replaces ``cpm_tpu/pallas/splat_mxu.py:_splat_kernel``. The kernel is
compiled with ``nvcc`` for ``sm_90a`` at first use into a shared library
with a plain C interface under ``cpm_tpu_torch/build/`` and loaded with
ctypes. Nothing is built or imported for CUDA when this module is
imported.

:func:`splat_product` takes CPU tensors to :func:`splat_product_torch` and
CUDA tensors to the kernel; tensors on another device, or of another
type, shape or layout, raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from cpm_tpu_torch.core.types import full_fp32_matmul

Tensor = torch.Tensor

# Ratio of the radial Epanechnikov mass (2*pi*r^3/5) to the product kernel
# mass (r^3), so both deposit the same expected irradiance.
PRODUCT_KERNEL_MATCH = 0.4 * math.pi

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "splat_product.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def inverse_radius(radius_rel: float) -> np.float32:
    """1 / r in float32, as both kernels compute it."""
    return np.float32(1.0) / np.float32(radius_rel)


def voxel_centres(n: int, device) -> Tensor:
    """(i + 0.5) / n for i < n, each a correctly rounded float32 division as
    the kernel computes it. Made on the host: a CUDA tensor divided by a
    Python number is multiplied by the rounded reciprocal instead, which
    moves a centre by an ulp and, through the cancellation in 1 - d^2, a
    weight at the edge of the support by ~1e-5."""
    c = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    return torch.from_numpy(c).to(device)


def splat_product_torch(positions: Tensor, powers: Tensor,
                        radius_rel: float, out_dim: tuple,
                        chunk: int = 16384) -> Tensor:
    """Plain version: the separable kernel as a dense contraction per chunk
    of deposits, the twin of ``cpm_tpu.ops.splat.splat_product_xla``.
    ``powers`` already carry the scale and validity mask."""
    full_fp32_matmul()
    d, h, w = out_dim
    dev = positions.device
    inv_r = float(inverse_radius(radius_rel))

    zc, yc, xc = (voxel_centres(n, dev) for n in (d, h, w))

    def kern(c, p):
        dist = (c[None, :] - p[:, None]) * inv_r
        return torch.clamp(0.75 * (1.0 - dist * dist), min=0.0)

    acc = torch.zeros((d * h, w * 3), dtype=torch.float32, device=dev)
    for lo in range(0, positions.shape[0], chunk):
        p = positions[lo:lo + chunk]
        pp = powers[lo:lo + chunk]
        a = (kern(zc, p[:, 2])[:, :, None]
             * kern(yc, p[:, 1])[:, None, :]).reshape(-1, d * h)
        b = (kern(xc, p[:, 0])[:, :, None] * pp[:, None, :]).reshape(-1, w * 3)
        acc.addmm_(a.T, b)
    return acc.reshape(d, h, w, 3)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or "
                               "CUDA_HOME")
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    return path


@functools.cache
def build() -> tuple[Path, str]:
    """Compile the kernel (once per source version) and return the shared
    library's path and the compiler's log."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"splat_product_{tag}.so"
    log = ""
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{log}")
        os.replace(tmp, lib)
    return lib, log


@functools.cache
def _entry():
    fn = ctypes.CDLL(str(build()[0])).cpm_splat_product
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(positions: Tensor, powers: Tensor, radius_rel: float,
                  out_dim: tuple) -> None:
    for name, t in (("positions", positions), ("powers", powers)):
        if t.device != positions.device:
            raise ValueError("positions and powers lie on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (M, 3), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if powers.shape[0] != positions.shape[0]:
        raise ValueError("positions and powers differ in length")
    if positions.shape[0] >= 2 ** 31:
        raise ValueError("too many deposits for one launch")
    if len(out_dim) != 3 or min(out_dim) < 1:
        raise ValueError(f"bad output shape {out_dim}")
    if not (math.isfinite(radius_rel) and radius_rel > 0.0):
        raise ValueError(f"bad radius {radius_rel}")


def splat_product(positions: Tensor, powers: Tensor, radius_rel: float,
                  out_dim: tuple) -> Tensor:
    """Splat (M, 3) deposits into a (D, H, W, 3) grid with the
    product-Epanechnikov kernel; ``powers`` already carry the irradiance
    scale and validity mask, unused slots sit at positions >= 1e30.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    (``splat_product.launches`` counts the launches); tensors on any other
    device, or of another type, shape or layout, raise."""
    radius_rel = float(np.float32(radius_rel))
    _check_inputs(positions, powers, radius_rel, out_dim)
    d, h, w = (int(s) for s in out_dim)
    if positions.device.type == "cpu":
        return splat_product_torch(positions, powers, radius_rel, (d, h, w))
    if positions.device.type != "cuda":
        raise ValueError(f"deposits are on {positions.device}; the splat "
                         "takes CUDA tensors (kernel) or CPU tensors (plain "
                         "version)")
    out = torch.zeros((d, h, w, 3), dtype=torch.float32,
                      device=positions.device)
    m = positions.shape[0]
    if m == 0:
        return out
    fn = _entry()
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(positions.data_ptr(), powers.data_ptr(), m, radius_rel,
                 float(inverse_radius(radius_rel)), d, h, w, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"splat kernel launch failed: CUDA error {err}")
    splat_product.launches += 1
    return out


splat_product.launches = 0

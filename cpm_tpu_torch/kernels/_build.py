"""The one build routine of the port's CUDA libraries.

A source under ``cpm_tpu_torch/csrc`` is compiled with ``nvcc`` for
``sm_90a`` at first use into a shared library with a plain C interface
under ``cpm_tpu_torch/build/`` (git-ignored), named by a hash of the
source and its flags, so an edited source or a changed flag builds anew.
The wrappers load it with ctypes. Nothing is built when a module is
imported.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
# Every library: Hopper's sm_90a, a shared object, and the compiler's
# resource report (registers, spills) in the log.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or "
                               "CUDA_HOME")
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    return path


@functools.cache
def build(source: Path, flags: tuple) -> tuple[Path, str]:
    """Compile ``source`` with ``flags`` (once per source version and
    flags) and return the shared library's path and the compiler's log,
    empty when the library was already there. Raises when nvcc fails."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}_{tag}.so"
    log = ""
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{log}")
        os.replace(tmp, lib)
    return lib, log

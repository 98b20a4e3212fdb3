"""Shared helpers of the benchmark's own tests: a cell's run on the CPU at
the tests' small size (a 16^3 volume, 32 x 32 photons a light, a 32^2
image), one interaction after no warm-up."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = ("cfg5-tf-edit", "cfg3-orbit", "cfg5-refine")


def small(workload: str) -> dict:
    kind = "ct_head_like" if workload.startswith("cfg3") else "smoke_cloud"
    return {"photons_x": 32, "photons_y": 32,
            "image": {"width": 32, "height": 32},
            "volume": {"kind": kind, "dim": 16}}


def run_small(workload: str, seed: int = 2 ** 33 + 7, side=None,
              root=None, mix=None, device="cpu", cfg=None):
    from cpmbench.harness.cell import run_cell
    torch.set_num_threads(2)
    return run_cell(workload, seed, 0.0, False, time.perf_counter(),
                    device=device, root=root, side=side,
                    cfg_overrides=dict(small(workload), **(cfg or {})),
                    mix_overrides=dict({"warmup": 0}, **(mix or {})),
                    log=lambda msg: None)


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

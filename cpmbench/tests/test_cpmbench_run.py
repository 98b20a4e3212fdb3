"""The command's refusals: without a card it exits with 2 and prints no
result, and it does so in a directory that holds the benchmark alone."""

import shutil
import subprocess
import sys

import pytest
import torch

from cpmbench.tests.conftest import ROOT

ARGS = ["--workload", "cfg3-orbit", "--seed", str(2 ** 33), "--seconds",
        "1", "--trace", "0"]


def run(root):
    return subprocess.run([sys.executable, str(root / "cpmbench" / "run.py"),
                           *ARGS], capture_output=True, text=True,
                          timeout=300, cwd=root)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run(ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cpmbench", tmp_path / "cpmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

"""The reference against a small run of each cell's traffic on the CPU
(a 16^3 volume, 32 x 32 photons a light): the program's plain paths agree
with it exactly, and the result has the contract's shape."""

import json
import math

import pytest

from cpmbench.tests.conftest import WORKLOADS, run_small


@pytest.mark.parametrize("workload", WORKLOADS)
def test_small_run_is_correct(workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        if name != "drift_err":  # the summation order of many updates
            assert c["value"] == 0.0, (name, c)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_schema(workload):
    r = run_small(workload)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"]
    assert len(r["metrics"]) >= 2
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)

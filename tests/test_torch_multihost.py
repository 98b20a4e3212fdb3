"""The port's multi-host layer (``cpm_tpu_torch/parallel/multihost.py``): a
world of 4 gloo processes on the CPU as 2 hosts x 2 chips running
``multihost_full_step`` (sweep and marcher) against the port's
single-device frame, the groups of ``make_hosts_chips_mesh``, the
chips-then-hosts reduction, ``dcn_scaling_budget`` against the
reference's, and ``initialize_distributed`` without a world. The world
is tests/test_torch_sharding.py's, at the same sizes and tolerances."""

import json

import pytest
import torch.distributed as dist

from cpm_tpu.core.config import PipelineConfig as JPipelineConfig
from cpm_tpu.parallel import multihost as jmh
from cpm_tpu_torch.core.config import PipelineConfig
from cpm_tpu_torch.parallel import multihost as mh
from test_torch_sharding import (METHODS, expect_close_to_jax,
                                 expect_frame_close, expect_photons_equal,
                                 run_world)

N_HOSTS, N_CHIPS = 2, 2


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(N_HOSTS * N_CHIPS, tmp_path_factory.mktemp("world4"),
                     n_hosts=N_HOSTS)


@pytest.mark.parametrize("method", METHODS)
def test_multihost_photons_equal_single_device_lane_by_lane(world4, method):
    expect_photons_equal(world4, method)


@pytest.mark.parametrize("method", METHODS)
def test_multihost_frame_matches_single_device(world4, method):
    expect_frame_close(world4, method)


@pytest.mark.parametrize("method", METHODS)
def test_multihost_frame_matches_reference(world4, method):
    expect_close_to_jax(world4, method)


def test_hosts_chips_groups(world4):
    """Rank r sits at (r // chips, r % chips); its chips group is its host
    row, its hosts group its chip column."""
    for rank, out in enumerate(world4["ranks"]):
        host, chip = divmod(rank, N_CHIPS)
        assert json.loads(str(out["groups"])) == {
            "host": host, "chip": chip,
            "chips": [host * N_CHIPS + c for c in range(N_CHIPS)],
            "hosts": [h * N_CHIPS + chip for h in range(N_HOSTS)]}


def test_two_all_reduces_per_multihost_trace_splat(world4):
    """The light volume's reduction: within the host first, then across
    the hosts, and no other collective in the trace and splat."""
    for out in world4["ranks"]:
        assert json.loads(str(out["all_reduce_calls"])) == [
            ["chips", N_CHIPS], ["hosts", N_HOSTS]]


@pytest.mark.parametrize("step_time_s,n_hosts,dcn_bytes_per_s", [
    (0.091, 4, 25e9), (0.0008, 4, 1.5e9), (0.5, 2, 1e10)])
def test_dcn_scaling_budget_matches_reference(step_time_s, n_hosts,
                                              dcn_bytes_per_s):
    """The inputs of tests/test_multihost.py:153-165, and one more."""
    want = jmh.dcn_scaling_budget(JPipelineConfig(), step_time_s, n_hosts,
                                  dcn_bytes_per_s)
    got = mh.dcn_scaling_budget(PipelineConfig(), step_time_s, n_hosts,
                                dcn_bytes_per_s)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0), k


def test_initialize_distributed_is_a_no_op_without_a_world(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mh.initialize_distributed("gloo")
    assert not dist.is_initialized()

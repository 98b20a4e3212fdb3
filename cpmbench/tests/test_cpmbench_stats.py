"""The percentile, rate and idle-union arithmetic on synthetic values."""

import math

import pytest

from cpmbench.harness import stats
from cpmbench.harness.devtrace import DeviceTrace


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 0) == 1
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_over_the_window():
    assert stats.rate(300, 15.0) == 20.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_gaps_and_busy_of_overlapping_intervals():
    iv = [(1, 3), (2, 4), (6, 7), (-5, 0.5), (9, 20)]
    assert stats.merge_intervals(iv, 0, 10) == [(0, 0.5), (1, 4), (6, 7),
                                                (9, 10)]
    assert stats.busy(iv, 0, 10) == pytest.approx(0.5 + 3 + 1 + 1)
    assert stats.gaps(iv, 0, 10) == [(0.5, 1), (4, 6), (7, 9)]
    assert stats.busy([], 0, 10) == 0
    assert stats.gaps([], 0, 10) == [(0, 10)]


def test_device_trace_idle_share_and_labels():
    t = DeviceTrace(window=(0.0, 10e6),
                    device=[("k1", 0.0, 2e6), ("k2", 1e6, 4e6),
                            ("k1", 6e6, 7e6)],
                    spans=[("render", 3.5e6, 5e6), ("trace", 6.5e6, 9e6)])
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s() == pytest.approx(5.0)
    idle = 100 * (1 - t.busy_s() / t.window_s)
    assert math.isclose(idle, 50.0)
    assert t.kernel_s(lambda n: n == "k1") == pytest.approx(3.0)
    assert t.top_ops() == [["k1", pytest.approx(3.0)],
                           ["k2", pytest.approx(3.0)]]
    # Gaps (4, 6) start inside "render", (7, 10) inside "trace".
    assert dict(t.idle_by_span()) == {"render": pytest.approx(2.0),
                                      "trace": pytest.approx(3.0)}

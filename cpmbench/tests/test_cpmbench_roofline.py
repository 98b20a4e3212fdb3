"""The work counts at small shapes, against counts by hand."""

import pytest

from cpmbench.reference import sweep_render as S
from cpmbench.reference.camera import Camera
from cpmbench.reference.config import RenderConfig
from cpmbench.roofline import peaks, sweep, tf, trace


def test_tf_evaluation_is_a_binary_search():
    assert [tf.search_ops(p) for p in (2, 3, 4, 5, 256, 40000)] == [
        1, 2, 2, 3, 8, 16]
    assert tf.eval_ops(4, 4) == 2 + 2 + 8
    assert tf.eval_ops(4, 1) == 2 + 2 + 2


def test_trace_work_by_hand():
    work = {"lane_flights": 10, "tests": 4, "interactions": 2}
    ops, nbytes = trace.trace_work(work, lanes=3, max_interactions=2,
                                   volume_shape=(2, 2, 2), tf_points=4,
                                   scattering_points=4)
    flight = 115 + 4 + 4 + 6 + 12 + 6
    test = 12 + 14 + 8 + 2 + (2 + 2 + 2)
    interaction = 2 * (115 + 4) + 3 + 6 + 10 + 15 + 18 + (2 + 2 + 2)
    assert ops == 10 * flight + 4 * test + 2 * interaction
    assert nbytes == 4 * 8 + 44 * 3 + 32 * 2 * 3 + 12 * 3
    assert trace.grids_work((16, 16, 9), 8) == (2.0 * 16 * 16 * 9,
                                               4.0 * 16 * 16 * 9 + 8 * 8)
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_sweep_samples_in_the_box_by_brute_force():
    cam = Camera.create(eye=(0.3, 0.6, -1.2), device="cpu")
    rc = RenderConfig(width=16, height=16)
    n_planes = 8
    sched = S._plane_schedule(cam, 2, 1, n_planes, 16, 16)
    u, v = S.base_grid(sched, 128, 128)
    want = 0
    for k in range(n_planes):
        if not bool(sched.valid[k]):
            continue
        w = float(sched.w_planes[k])
        for uu in u.tolist():
            b = float(sched.o_b) + w * (uu - float(sched.o_b))
            if not 0.0 <= b <= 1.0:
                continue
            for vv in v.tolist():
                c = float(sched.o_c) + w * (vv - float(sched.o_c))
                want += 0.0 <= c <= 1.0
    got = sweep.in_box_samples(sched, u, v)
    assert abs(got - want) <= 2 * n_planes  # float32 against float64 edges
    ops, nbytes = sweep.forward_work((8, 8, 8), 5, cam, rc, 4)
    assert ops == got * (42 + tf.eval_ops(4, 4)) + n_planes * 2 * (
        64 + 3 * 25)
    assert nbytes == 4 * 512 + 12 * 125 + 16 * 128 * 128

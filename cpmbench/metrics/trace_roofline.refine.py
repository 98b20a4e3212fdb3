"""trace_roofline.refine: the trace's share of its roofline: the least
time of every trace of the traced window and its grids' pre-pass
(:mod:`cpmbench.roofline.trace`, from the reference's count of the work
of the run's first trace, each pass drawing fresh streams over the same
volume) over the device time of the trace and pre-pass kernels, from the
profiler."""

import re

from cpmbench.roofline import trace

KERNELS = re.compile(r"\b(woodcock_trace_kernel|woodcock_trace_global_tf_kernel"
                     r"|trace_grids_\w+_kernel)\b")


def read(run):
    passes = run.count("passes")
    if run.trace is None or not run.trace_work or not passes:
        return None
    device_s = run.trace.kernel_s(lambda n: KERNELS.search(n) is not None)
    if device_s <= 0:
        return None
    cfg = run.cfg
    dim = cfg["volume"]["dim"]
    lanes = cfg["photons_x"] * cfg["photons_y"] * len(cfg["lights"])
    points = len(cfg["tf"]["positions"])
    per_pass = trace.bound_s(run.trace_work, lanes, cfg["max_interactions"],
                             (dim, dim, dim), points, points)
    return 100.0 * per_pass * passes / device_s

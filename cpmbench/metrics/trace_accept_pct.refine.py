"""trace_accept_pct.refine: 100 x the trace kernel's accepted collisions
(scatters and absorptions) over its tentative collisions (acceptance
tests), as the kernel counts them into the program recorder's device
counters over the traced window (:mod:`cpmbench.metrics._program`)."""

from cpmbench.metrics._program import snapshot


def read(run):
    snap = snapshot()
    if snap is None:
        return None
    tests = snap["counters"].get("trace.tentative_collisions", 0)
    accepted = snap["counters"].get("trace.accepted_collisions", 0)
    if not tests:
        return None
    return 100.0 * accepted / tests

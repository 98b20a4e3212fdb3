"""frame_ms_p95: the 95th percentile, over every interaction of the
window, of its time from issue to its image finished on the card."""

from cpmbench.harness.stats import percentile


def read(run):
    return percentile(run.latencies_s, 95.0) * 1e3

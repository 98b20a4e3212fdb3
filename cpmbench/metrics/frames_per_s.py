"""frames_per_s: interactions completed over the whole window."""

from cpmbench.harness.stats import rate


def read(run):
    return rate(run.interactions, run.window_s)

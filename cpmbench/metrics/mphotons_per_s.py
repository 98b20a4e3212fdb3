"""mphotons_per_s: light samples traced (every sample of every full trace
and progressive pass of the window) over the whole window, in millions a
second."""

from cpmbench.harness.stats import rate


def read(run):
    if not run.count("light_samples_traced"):
        return None
    return rate(run.count("light_samples_traced"), run.window_s) / 1e6

"""device_idle_pct.frame: 100 x (1 - the union of the device's kernel,
copy and memset intervals over the traced window)."""

from cpmbench.metrics._idle import idle_pct


def read(run):
    return idle_pct(run)

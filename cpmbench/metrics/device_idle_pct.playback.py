"""device_idle_pct.playback: 100 x (1 - the union of the device's kernel,
copy and memset intervals over the traced window) of a playback run."""

from cpmbench.metrics._idle import idle_pct


def read(run):
    return idle_pct(run)

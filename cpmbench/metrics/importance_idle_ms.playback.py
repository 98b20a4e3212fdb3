"""importance_idle_ms.playback: the device's idle time under the program's
importance spans (the path importance and the selection of the correlated
batch, and any min/max or classification span) per frame of playback,
from the program's recorder (:mod:`cpmbench.metrics._program`)."""

from cpmbench.metrics._program import layer_idle_ms


def read(run):
    return layer_idle_ms(run, "importance", run.count("frames"))

"""importance_idle_ms.edit: the device's idle time under the program's
importance spans (the TF-change grid, its min/max, the host merge walk and
its reads, the path importance, the selection) per TF edit, from the
program's recorder (:mod:`cpmbench.metrics._program`)."""

from cpmbench.metrics._program import layer_idle_ms


def read(run):
    return layer_idle_ms(run, "importance", run.count("edits"))

"""trace_idle_ms.refine: the device's idle time under the program's trace
spans (the trace call: its constants and the grids' pre-pass, the
kernel's arguments, the launch, the photon map's fields) per pass, from
the program's recorder (:mod:`cpmbench.metrics._program`)."""

from cpmbench.metrics._program import layer_idle_ms


def read(run):
    return layer_idle_ms(run, "trace", run.count("passes"))

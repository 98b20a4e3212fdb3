"""render_idle_ms.frame: the device's idle time under the program's
render spans (the sweep: its plan, permute copies and schedule with the
camera's reads, each scan, the warp) per interaction, from the program's
recorder (:mod:`cpmbench.metrics._program`)."""

from cpmbench.metrics._program import layer_idle_ms


def read(run):
    return layer_idle_ms(run, "render", run.interactions)

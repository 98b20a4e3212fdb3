"""trace_ms.frame: the trace's event-timed span per interaction."""

from cpmbench.metrics._spans import per

SPANS = {"trace": [("cpm_tpu_torch.ops.tracer", "trace_photons")]}


def read(run):
    return per(run, ("trace",), run.interactions)

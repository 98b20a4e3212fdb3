"""trace_ms.refine: the trace's event-timed span per pass (a full trace
or a progressive pass)."""

from cpmbench.metrics._spans import per

SPANS = {"trace": [("cpm_tpu_torch.ops.tracer", "trace_photons")]}


def read(run):
    return per(run, ("trace",), run.count("passes"))

"""render_ms.frame: the render's event-timed span per interaction."""

from cpmbench.metrics._spans import per

SPANS = {"render": [("cpm_tpu_torch.ops.sweep_render", "sweep_render")]}


def read(run):
    return per(run, ("render",), run.interactions)

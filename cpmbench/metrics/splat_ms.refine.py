"""splat_ms.refine: the splat's event-timed span per pass."""

from cpmbench.metrics._spans import per

SPANS = {"splat": [("cpm_tpu_torch.ops.splat", "splat_all"),
                   ("cpm_tpu_torch.ops.splat", "splat_selected")]}


def read(run):
    return per(run, ("splat",), run.count("passes"))

"""importance_ms.edit: the importance layer's event-timed spans per TF
edit: the TF-change importance grid, the path importance and the
selection."""

from cpmbench.metrics._spans import per

SPANS = {
    "importance_grid": [("cpm_tpu_torch.pipeline.step",
                         "build_tf_change_importance_grid")],
    "path_importance": [("cpm_tpu_torch.ops.path_importance",
                         "photon_path_importance")],
    "select": [("cpm_tpu_torch.ops.select", "select_photons_to_recompute")],
}


def read(run):
    return per(run, tuple(SPANS), run.count("edits"))

"""A TF edit, as a user dragging TF handles makes one: every opacity times
a factor drawn from ``opacity_factor``, the next edit by its reciprocal
(``"alternate": "reciprocal"``), clamped to [0, 1]; one interior point
moved by a draw within +-``move_interior``, between its neighbours. It
hands the next steps the TF before the edit (``ctx["tf_before"]``) and
the scene before it (``ctx["prev_scene"]``)."""

import numpy as np

# The gap an edited TF point keeps from its neighbours.
TF_POINT_GAP = 1e-3


def run(s, step, ctx, record):
    p, mem = step.params, step.mem
    lo, hi = p["opacity_factor"]
    edits = mem.get("edits", 0)
    if p.get("alternate") == "reciprocal" and edits % 2:
        factor = 1.0 / mem["factor"]
    else:
        factor = mem["factor"] = float(s.draws.uniform(lo, hi))
    mem["edits"] = edits + 1
    s.counts["edits"] += 1
    pos, col = s.tf_pos.copy(), s.tf_col.copy()
    col[:, 3] = np.clip(col[:, 3] * np.float32(factor), 0.0, 1.0)
    if pos.shape[0] > 2 and p.get("move_interior"):
        i = int(s.draws.integers(1, pos.shape[0] - 1))
        moved = pos[i] + s.draws.uniform(-p["move_interior"],
                                         p["move_interior"])
        pos[i] = np.clip(moved, pos[i - 1] + TF_POINT_GAP,
                         pos[i + 1] - TF_POINT_GAP)
    ctx["tf_before"] = (s.tf_pos, s.tf_col)
    ctx["prev_scene"] = s.scene
    s.tf_pos, s.tf_col = pos, col
    s.scene = s.side.with_tf(s.scene, pos, col)

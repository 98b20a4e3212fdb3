"""The render of the state's running mean through the current camera
(``render_state``, the sweep). Checked on image rows drawn from the seed,
through the reference's own light volume where an earlier step of the
same interaction made one, else the program's."""

import torch

from cpmbench.harness.check import rel_err

# Image rows the comparison samples, drawn from the seed.
CHECK_ROWS = 48


def program(side, scene, state):
    return side.step.render_state(scene, state, side.config)


def reference(side, scene, state):
    return side.P.render(scene, state.light_volume_accum, side.config,
                         p=side.p)


def run(s, step, ctx, record):
    image = s.on(program, reference)(s.scene, s.state)
    s.counts["renders"] += 1
    if s.traced:
        s.notes["render"].append((dict(s.camera), s.tf_pos.shape[0]))
    if record is not None:
        record.steps.append(("render", {
            "state": s.state, "image": image, "camera": dict(s.camera),
            "tf": (s.tf_pos, s.tf_col)}))


def check(c, f):
    height = c.ref.config.render.height
    n = min(CHECK_ROWS, height)
    rows = torch.as_tensor(sorted(c.picks.choice(
        height, size=n, replace=False).tolist()), device=c.device)
    scene = c.scene(tf=f["tf"], camera=f["camera"])
    lv = c.carry.get("light_volume", f["state"].light_volume_accum)
    want = c.ref.P.render(scene, lv, c.ref.config, rows=rows)
    c.note("image_err", rel_err(f["image"][rows], want))

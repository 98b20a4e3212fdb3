"""The render of the state's running mean through the current camera
(``render_state``, the sweep) in playback, where the scene's volume is the
one the frame interpolated (after ``advance_time``). Checked on image rows
drawn from the seed, through the reference's scene with that frame's
volume (the reference's own mix at ``ctx["time"]``) and the reference's
own light volume where an earlier step of the same interaction made one,
else the program's."""

import dataclasses

import torch

from cpmbench.harness.check import rel_err
from cpmbench.ops.render import CHECK_ROWS, program, reference
from cpmbench.reference import timevarying as R


def run(s, step, ctx, record):
    image = s.on(program, reference)(s.scene, s.state)
    s.counts["renders"] += 1
    if record is not None:
        record.steps.append(("render_played", {
            "state": s.state, "image": image, "time": ctx["time"]}))


def check(c, f):
    height = c.ref.config.render.height
    n = min(CHECK_ROWS, height)
    rows = torch.as_tensor(sorted(c.picks.choice(
        height, size=n, replace=False).tolist()), device=c.device)
    scene = dataclasses.replace(c.base, volume=dataclasses.replace(
        c.base.volume, data=R.sequence_sample(c.s.sequence, f["time"])))
    lv = c.carry.get("light_volume", f["state"].light_volume_accum)
    want = c.ref.P.render(scene, lv, c.ref.config, rows=rows)
    c.note("image_err", rel_err(f["image"][rows], want))

"""``passes`` progressive passes (``progressive_step``): fresh streams,
the Knaus-Zwicker radius, the running mean. The check follows one pass an
interaction, the same in every image, drawn from the seed at set-up, from
the program's state before it."""

import dataclasses

from cpmbench.harness.check import lanes_differ, rel_err


def program(side, scene, state):
    return side.step.progressive_step(scene, state, side.config)


def reference(side, scene, state):
    it = state.photons.iteration + 1
    photons, lv, accum = side.P.progressive_pass(
        scene, state.light_samples, state.key, side.config, it,
        state.photons.radius_rel, state.light_volume_accum, p=side.p)
    return dataclasses.replace(state, photons=photons, light_volume=lv,
                               light_volume_accum=accum)


def setup(s, step):
    step.mem["checked"] = int(s.picks.integers(1, step.params["passes"]
                                               + 1))


def run(s, step, ctx, record):
    call = s.on(program, reference)
    for i in range(1, step.params["passes"] + 1):
        before = s.state
        s.state = call(s.scene, s.state)
        passed(s, record, before, i == step.mem["checked"])


def passed(s, record, before, kept: bool):
    """Counts a progressive pass and, if ``kept``, records it."""
    s.counts["light_samples_traced"] += s.state.light_samples.n
    s.counts["passes"] += 1
    if record is not None and kept:
        record.steps.append(("progressive", {
            "before": before, "after": s.state,
            "tf": (s.tf_pos, s.tf_col)}))


def check(c, f):
    before, after = f["before"], f["after"]
    photons, lv, accum = c.ref.P.progressive_pass(
        c.scene(tf=f["tf"]), c.start.light_samples, c.start.key,
        c.ref.config, int(before.photons.iteration) + 1,
        before.photons.radius_rel, before.light_volume_accum)
    c.note("photons_differ", lanes_differ(after.photons, photons))
    c.note("light_volume_err", rel_err(after.light_volume, lv))
    c.note("accum_err", rel_err(after.light_volume_accum, accum))
    c.carry.pop("light_volume", None)

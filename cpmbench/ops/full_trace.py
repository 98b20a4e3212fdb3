"""A full trace of every light sample under the state's own streams
(``full_trace_step``), the splat of all its photons. Checked against the
reference's full trace of the same samples and streams in the scene the
step saw (its TF and lights)."""

from cpmbench.harness.check import lanes_differ, rel_err


def program(side, scene, state):
    return side.step.full_trace_step(scene, state, side.config)


def reference(side, scene, state):
    return side.full_trace_step(scene, state)


def run(s, step, ctx, record):
    s.state = s.on(program, reference)(s.scene, s.state)
    traced(s, record)


def traced(s, record):
    """Counts a full trace of the current state and records it for the
    check."""
    s.counts["light_samples_traced"] += s.state.light_samples.n
    s.counts["passes"] += 1
    if record is not None:
        record.steps.append(("full_trace", {
            "after": s.state, "tf": (s.tf_pos, s.tf_col),
            "lights": [dict(x) for x in s.lights]}))


def check(c, f):
    want = c.full_trace(tf=f["tf"], lights=f["lights"])
    c.note("photons_differ", lanes_differ(f["after"].photons, want.photons))
    c.note("light_volume_err", rel_err(f["after"].light_volume,
                                       want.light_volume))
    c.carry["light_volume"] = want.light_volume_accum

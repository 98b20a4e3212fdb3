"""One batch of the correlated update for a TF or volume change, from a
fresh drain round, as the dispatcher starts one on a fresh invalidation,
through the update for multi-million-photon maps
(``correlated_step_scalable``): path importance over the grid of
``ctx["grid"]``, selection, retrace and the removed and added splats.
``batches`` batches an interaction.

Checked twice: a sampled batch from the program's state before it (its
photon map and light volume) through the reference's grid, path
importance, selection, retrace and both splats; and, once the window has
closed, the last state's light volume, which the window's batches updated
in place, against the reference's splat of the last photon map, so error
that builds up over many batches shows (``drift_err``)."""

import dataclasses

import torch

from cpmbench.harness.check import lanes_differ, rel_err


def program(side, scene, state, grid):
    state = dataclasses.replace(
        state, retraced=torch.zeros_like(state.retraced), n_remaining=0)
    budget = side.step.recompute_budget(side.config, state.photons.n)
    return side.step.correlated_step_scalable(scene, state, side.config,
                                              grid, budget)


def reference(side, scene, state, grid, retraced=None):
    """The batch from ``state``, selecting none of ``retraced`` (a fresh
    round's, none, by default)."""
    if retraced is None:
        retraced = torch.zeros_like(state.retraced)
    budget = side.P.recompute_budget(side.config, state.light_samples.n)
    out = side.P.correlated_update(
        scene, state.light_samples, state.key, side.config, state.photons,
        state.light_volume, retraced, grid, budget, p=side.p)
    return dataclasses.replace(
        state, photons=out["photons"], light_volume=out["light_volume"],
        light_volume_accum=out["light_volume"])


def run(s, step, ctx, record):
    for _ in range(step.params.get("batches", 1)):
        before = s.state
        s.state = s.on(program, reference)(s.scene, s.state, ctx["grid"])
        batched(s, record, ctx, before, None)


def batched(s, record, ctx, before, retraced):
    """Counts a batch and records it for the check; ``retraced``: the
    lanes a continued drain round excludes, None on a fresh round."""
    s.counts["batches"] += 1
    if record is not None:
        record.steps.append(("correlated_step", {
            "before": before, "after": s.state, "retraced": retraced,
            "tf": (s.tf_pos, s.tf_col), "grid_ref": ctx["grid_ref"]}))


def check(c, f):
    before = f["before"]
    state = dataclasses.replace(
        c.start, photons=before.photons, light_volume=before.light_volume,
        light_volume_accum=before.light_volume)
    out = reference(c.ref, c.scene(tf=f["tf"]), state, f["grid_ref"](c),
                    f["retraced"])
    c.note("photons_differ", lanes_differ(f["after"].photons, out.photons))
    c.note("light_volume_err", rel_err(f["after"].light_volume,
                                       out.light_volume))
    c.carry["light_volume"] = out.light_volume_accum


def final(c, step, state):
    P = c.ref.P
    want = P.splat.splat_all(state.photons,
                             P.light_volume_shape(c.ref.config))
    c.note("drift_err", rel_err(state.light_volume, want))

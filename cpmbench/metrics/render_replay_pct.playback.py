"""render_replay_pct.playback: the share of the program's sweep renders on
the card that replayed a captured CUDA graph while the volume changes every
frame, 100 x replays / (replays + captures + renders run eagerly), from the
program recorder's host counters (:mod:`cpmbench.metrics._program`),
counted over the whole run as ``render_replay_pct.frame`` counts them. A
program without the counters, or one that rendered nothing on the card,
gives no reading."""

from cpmbench.metrics._program import snapshot

COUNTERS = ("render.graph_replays", "render.graph_captures",
            "render.graph_eager")


def read(run):
    snap = snapshot()
    if snap is None:
        return None
    replays, captures, eager = (snap["counters"].get(name, 0)
                                for name in COUNTERS)
    renders = replays + captures + eager
    if not renders:
        return None
    return 100.0 * replays / renders

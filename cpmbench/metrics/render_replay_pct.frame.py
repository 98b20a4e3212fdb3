"""render_replay_pct.frame: the share of the program's sweep renders on the
card that replayed a captured CUDA graph, 100 x replays / (replays +
captures + renders run eagerly), from the program recorder's host counters
``render.graph_replays``, ``render.graph_captures`` and
``render.graph_eager`` (:mod:`cpmbench.metrics._program`). They count
always and the harness does not reset the recorder, so the share covers
the run's set-up and warm-up and the interactions after the traced window
besides the window itself. A program without the counters, or one that
rendered nothing on the card, gives no reading."""

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

"""Shared arithmetic of the readers of the program's own spans and
counters: the recorder of ``cpm_tpu_torch/core/telemetry.py``, which
records while the traced window's profiler records, on the profiler's host
clock (``time.time_ns``).

Each idle stretch of the window's device trace is put down to the
innermost program span open on the host where it starts, the rule
:meth:`cpmbench.harness.devtrace.DeviceTrace.idle_by_span` applies to the
benchmark's own spans, and to the layers of that span and of every span
open around it (a span's layer is its name's first part: ``importance``,
``trace``, ``splat``, ``render``, ``pipeline``, ``scene`` or ``wait``).
A program without the recorder gives no reading.
"""

from __future__ import annotations

import sys

from cpmbench.harness import stats

# Per traced window: (its trace, the attribution).
_cache: dict = {}


def snapshot():
    """The program recorder's snapshot, or None where the program has no
    recorder or it recorded nothing."""
    try:
        from cpm_tpu_torch.core import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    if not snap["spans"] and not snap["counters"]:
        return None
    return snap


def attribute(spans: list, intervals: list, window: tuple) -> dict:
    """The idle stretches of ``window`` (us) outside the device
    ``intervals`` (us), put down to the program ``spans`` ((name, parent,
    start ns, end ns), as the recorder gives them): ``idle_s``, all of
    it; ``by_stage``, seconds by the innermost span open at each
    stretch's start ("no span" where none is); ``by_layer``, seconds by
    the layer of that span and of each span around it, a stretch counted
    once a layer."""
    order = sorted((i for i, s in enumerate(spans) if s[3] is not None),
                   key=lambda i: spans[i][2])
    by_stage, by_layer, idle = {}, {}, 0.0
    active, k = [], 0
    for s, e in stats.gaps(intervals, *window):
        t = s * 1e3  # ns
        while k < len(order) and spans[order[k]][2] <= t:
            active.append(order[k])
            k += 1
        active = [i for i in active if spans[i][3] >= t]
        dt = (e - s) * 1e-6
        idle += dt
        if not active:
            by_stage["no span"] = by_stage.get("no span", 0.0) + dt
            continue
        inner = max(active, key=lambda i: (spans[i][2], i))
        by_stage[spans[inner][0]] = by_stage.get(spans[inner][0], 0.0) + dt
        layers, i = set(), inner
        while i >= 0:
            layers.add(spans[i][0].split(".", 1)[0])
            i = spans[i][1]
        for layer in layers:
            by_layer[layer] = by_layer.get(layer, 0.0) + dt
    return {"idle_s": idle, "by_stage": by_stage, "by_layer": by_layer}


def idle(run):
    """The attribution of ``run``'s traced window, or None."""
    if run.trace is None:
        return None
    key = id(run.trace)
    if key in _cache and _cache[key][0] is run.trace:
        return _cache[key][1]
    snap = snapshot()
    if snap is None:
        return None
    got = attribute(snap["spans"], run.trace.intervals(), run.trace.window)
    _cache.clear()
    _cache[key] = (run.trace, got)
    total = got["idle_s"] or 1.0
    top = sorted(got["by_stage"].items(), key=lambda x: -x[1])[:8]
    under = 100.0 * (1.0 - got["by_stage"].get("no span", 0.0) / total)
    print("program idle by stage (s, share of idle): " + ", ".join(
        f"{n} {t:.3f} {100 * t / total:.1f}%" for n, t in top)
        + f"; under some span {under:.1f}%", file=sys.stderr, flush=True)
    return got


def layer_idle_ms(run, layer: str, count: int):
    """Device idle under ``layer``'s spans, in ms per ``count``."""
    got = idle(run)
    if got is None or not count or layer not in got["by_layer"]:
        return None
    return got["by_layer"][layer] * 1e3 / count


def waits(snap) -> dict:
    """Host seconds blocked in each ``wait.<site>`` span, by site."""
    out = {}
    for name, _, start, end in snap["spans"]:
        if name.startswith("wait.") and end is not None:
            site = name[len("wait."):]
            out[site] = out.get(site, 0.0) + (end - start) * 1e-9
    return out

"""One run of one cell: set-up, warm-up on the cell's own traffic, the
measured window, then (outside the window) the host-wait count of a traced
run, the check against the reference and the metrics' readers."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
import warnings
from pathlib import Path

import torch

from cpmbench.harness import check as check_mod
from cpmbench.harness import stats
from cpmbench.harness.backends import ProgramBackend
from cpmbench.harness.registry import Registry
from cpmbench.harness.session import Reservoir, Session

# Interactions a traced run repeats under torch's sync debug mode, after
# its window, to count the host's waits for the card.
HOST_WAIT_INTERACTIONS = 3

# Top-level modules that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "cpm_tpu")


@dataclasses.dataclass
class Run:
    """What the metrics' readers read."""

    device: object
    cfg: dict
    setup_s: float
    latencies_s: list
    window_s: float
    counts: dict  # what the window's steps did, by name
    spans: dict | None = None  # name -> (calls, ms)
    trace: object = None  # devtrace.DeviceTrace
    host_waits: float | None = None  # per interaction
    notes: dict | None = None  # what a traced window's steps kept
    trace_work: dict | None = None  # the reference's start trace's work

    @property
    def interactions(self) -> int:
        return self.counts.get("interactions", 0)

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def count_host_waits(session: Session, n: int) -> float:
    """The host's waits for the card per interaction over ``n``
    interactions, as torch's sync debug mode reports them."""
    synchronize(session.device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(n):
                session.interaction()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    synchronize(session.device)
    return sum("synchroniz" in str(w.message) for w in caught) / n


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             started: float, device="cuda", root: Path | None = None,
             side=None, cfg_overrides: dict | None = None,
             mix_overrides: dict | None = None, log=None) -> dict:
    """The result of one run: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (without its name and count, which the caller
    adds), ``breakdown`` of a traced run, and ``checks``, the numbers
    compared beside their limits. ``started`` is the process's start on
    ``time.perf_counter``'s clock; ``side(cfg, device, registry)`` makes
    what replaces the program (a control); ``cfg_overrides`` replace
    configuration
    keys (the tests' small sizes), ``mix_overrides`` the traffic mix's
    (a control's warm-up)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    reg = Registry(root) if root else Registry()
    cell = reg.workload(workload)
    cfg = dict(reg.config(cell["config"]), **(cfg_overrides or {}))
    mix = dict(reg.traffic(cell["traffic"]), **(mix_overrides or {}))
    limits = reg.limits(workload)
    device = torch.device(device)
    side = (side or ProgramBackend)(cfg, device, reg)

    session = Session(side, cfg, mix, seed, device, reg)
    session.setup()
    for _ in range(mix["warmup"]):
        session.interaction()
    synchronize(device)
    reservoir = Reservoir(mix["sample"], session.picks)
    counted = dict(session.counts)

    spans = trace = None
    latencies = []
    # What set-up made stays out of the collector's scans in the window.
    gc.collect()
    gc.freeze()
    if traced:
        from cpmbench.harness import devtrace
        from cpmbench.harness.spans import Spans
        targets = {}
        for entry in reg.metrics(workload, True):
            targets.update(getattr(reg.module("metrics", entry["name"]),
                                   "SPANS", {}))
        session.traced = True
        spans = Spans(targets)
        with spans.installed(), devtrace.traced_window() as trace:
            t0, t_end = _window(session, reservoir, seconds, latencies,
                                device, labelled=True)
        session.traced = False
    else:
        t0, t_end = _window(session, reservoir, seconds, latencies, device)
    setup_s, window_s = t0 - started, t_end - t0
    gc.unfreeze()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded by the run: {found}")

    run = Run(device=device, cfg=cfg,
              setup_s=setup_s, latencies_s=latencies, window_s=window_s,
              counts={k: v - counted.get(k, 0)
                      for k, v in session.counts.items()})
    if traced:
        log(f"traced window closed {time.perf_counter() - t_end:.3f} s "
            f"after its end; {len(trace.device)} device records")
        run.spans, run.trace = spans.totals_ms(), trace
        run.notes = dict(session.notes)
        run.host_waits = count_host_waits(session, HOST_WAIT_INTERACTIONS)
    log(f"window: {run.interactions} interactions in {window_s:.3f} s; "
        f"set-up {setup_s:.3f} s; memory peak {memory_peak} B")
    log(latency_summary(latencies, window_s))

    # The reference runs once the program's state is let go of, but for
    # its last state and what the kept interactions hold.
    final_state = session.state
    session.state = session.scene = None
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checker = check_mod.Checker(session)
    numbers = checker.run(reservoir.kept, final_state)
    final_state = None
    correct, checks = check_mod.judge(numbers, limits)
    run.trace_work = checker.trace_work
    log(f"check: {time.perf_counter() - t_check:.3f} s")

    t_read = time.perf_counter()
    metrics = {}
    for entry in reg.metrics(workload, traced):
        value = reg.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    log(f"metrics read in {time.perf_counter() - t_read:.3f} s")
    result = {"correct": bool(correct), "attempted": run.interactions,
              "failed": 0, "metrics": metrics,
              "device": {"memory_peak_bytes": int(memory_peak)}}
    if traced:
        result["device"]["busy_s"] = trace.busy_s()
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_by_span()}
    result["checks"] = checks
    return result


def _window(session: Session, reservoir: Reservoir, seconds: float,
            latencies: list, device, labelled: bool = False) -> tuple:
    """The closed loop for ``seconds``: each interaction from its issue to
    its image finished on the card; returns (the first one's issue, the
    last one's end)."""
    t0 = time.perf_counter()
    t_end = t0
    while not latencies or t_end - t0 < seconds:
        t_issue = time.perf_counter()
        record = reservoir.record()
        if labelled:
            with torch.profiler.record_function("cpmbench.interaction"):
                session.interaction(record)
        else:
            session.interaction(record)
        synchronize(device)
        t_end = time.perf_counter()
        latencies.append(t_end - t_issue)
    return t0, t_end


def latency_summary(latencies: list, window_s: float, slices: int = 10
                    ) -> str:
    """A line on how the window's latencies lie: their percentiles in ms,
    and per tenth of the window how many took over 1.1 times the median,
    so that a tail from a burst shows apart from a tail spread evenly."""
    if not latencies:
        return "latencies: none"
    ms = [x * 1e3 for x in latencies]
    med = stats.percentile(ms, 50.0)
    q = " ".join(f"p{p}={stats.percentile(ms, p):.3f}"
                 for p in (50, 90, 95, 99, 100))
    t, per = 0.0, [0] * slices
    for x in latencies:
        t += x
        if x * 1e3 > 1.1 * med:
            per[min(int(t / max(window_s, 1e-9) * slices), slices - 1)] += 1
    return f"latencies ms: {q}; over 1.1 x median by tenth: {per}"

"""The device trace of a traced window, from ``torch.profiler``: every
device record (kernels, copies, memsets) with its name and interval, the
benchmark's own spans (``cpmbench.*`` ranges) on the host, and the window
itself, all on the profiler's one clock (microseconds)."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from cpmbench.harness import stats

WINDOW = "cpmbench.window"


@dataclass
class DeviceTrace:
    window: tuple = (0.0, 0.0)  # (start, end) us
    device: list = field(default_factory=list)  # (name, start, end) us
    spans: list = field(default_factory=list)  # (name, start, end) us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def intervals(self) -> list:
        return [(s, e) for _, s, e in self.device]

    def busy_s(self) -> float:
        return stats.busy(self.intervals(), *self.window) * 1e-6

    def kernel_s(self, match) -> float:
        """Summed seconds of the device records whose name ``match``
        accepts, within the window."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.device
                   if match(n) and e > lo and s < hi) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_by_span(self, k: int = 10) -> list:
        """The window's idle time summed by the innermost benchmark span
        open on the host where each idle stretch starts ("no span" where
        none is)."""
        spans = sorted(self.spans, key=lambda x: x[1])
        by, active, i = {}, [], 0
        for s, e in stats.gaps(self.intervals(), *self.window):
            while i < len(spans) and spans[i][1] <= s:
                active.append(spans[i])
                i += 1
            active = [x for x in active if x[2] >= s]
            label = max(active, key=lambda x: x[1])[0] if active else "no span"
            by[label] = by.get(label, 0.0) + (e - s) * 1e-6
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]


def _records(prof):
    """(name, is_device, start_us, end_us) of every record of the trace.
    The profiler also puts each host range on the device's timeline (a
    user annotation, under the range's own name): those are the host's,
    not the device's."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = (e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith("cpmbench."))
        start = e.start_ns() / 1e3
        out.append((e.name(), dev, start, start + e.duration_ns() / 1e3))
    return out


@contextlib.contextmanager
def traced_window():
    """Profile the ``with`` block as one window; yields the
    :class:`DeviceTrace`, filled when the block ends."""
    from torch.profiler import ProfilerActivity, profile
    trace = DeviceTrace()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield trace
            torch.cuda.synchronize()
    for name, dev, s, e in _records(prof):
        if dev:
            trace.device.append((name, s, e))
        elif name == WINDOW:
            trace.window = (s, e)
        elif name.startswith("cpmbench."):
            trace.spans.append((name[len("cpmbench."):], s, e))
    if not trace.device:
        raise RuntimeError("the profiler's window holds no device records")

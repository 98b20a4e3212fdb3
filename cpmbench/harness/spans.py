"""Spans recorded from the benchmark's own side, in traced runs only:
module attributes of the program, which the program calls through their
modules, are wrapped for the run so that each call opens a
``torch.profiler.record_function`` range named ``cpmbench.<span>`` and is
timed by CUDA events. Which attributes a span wraps, each per-layer
metric's reader says in its ``SPANS``: span name -> [(module, attribute),
...]."""

from __future__ import annotations

import contextlib
import functools
import importlib

import torch

class Spans:
    """The spans of one traced window: per name, the (start, end) CUDA
    events of each call of the attributes ``targets[name]`` lists."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.events = {name: [] for name in targets}
        self._saved = []

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(f"cpmbench.{name}"):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                self.events[name].append((start, end))
                return out
        return wrapper

    @contextlib.contextmanager
    def installed(self):
        """The wrappers in place for the ``with`` block."""
        for name, targets in self.targets.items():
            for mod_name, attr in targets:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
                self._saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(name, fn))
        try:
            yield self
        finally:
            for mod, attr, fn in reversed(self._saved):
                setattr(mod, attr, fn)
            self._saved.clear()

    def totals_ms(self) -> dict:
        """Per span name: (calls, summed milliseconds between its events)."""
        torch.cuda.synchronize()
        return {name: (len(ev), sum(s.elapsed_time(e) for s, e in ev))
                for name, ev in self.events.items()}

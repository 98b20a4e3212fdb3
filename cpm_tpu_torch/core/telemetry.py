"""The program's spans and counters, on the profiler's clock.

One recorder for the whole package. It records only while a torch
profiler records (``torch.autograd._profiler_enabled()``): with none, a
span or a host-wait helper is one flag test and keeps nothing. There is no
other switch.

- **Spans** (:func:`span`, :func:`spanned`): a name, the span open around
  it (its parent) and the host's start and end in nanoseconds from
  ``time.time_ns()``, the clock the profiler stamps its host events with,
  so that a span lines up with the profiler's device records without
  conversion. Spans carry host time only: they record no CUDA event and no
  profiler range, so they put nothing on the device's timeline.
- **Host waits** (:func:`wait`): every place where the host waits for the
  card, a read of device values or an upload of host values, goes through
  it; while recording, it opens a span ``wait.<site>`` and counts the
  site.
- **Counters**: host-side named integers (each host wait's site, while
  recording; what :func:`count` and :func:`count_change` count, always);
  the kernels' counters
  (:func:`device_counters`), one int64 buffer a device that kernels add
  to without a host wait and that only :func:`snapshot` reads; and the
  kernel wrappers' launches (:func:`launched`, :func:`launches`), which
  are counted always.

:func:`snapshot` returns what was recorded and :func:`reset` clears it.
Nothing is written to a file.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch

recording = torch.autograd._profiler_enabled

# The kernels' counters, in the order of their slots in a device's buffer:
# the trace's acceptance tests (tentative collisions) and its accepted
# collisions (scatters and absorptions).
DEVICE_COUNTERS = ("trace.tentative_collisions", "trace.accepted_collisions")

# Each span: [name, parent index (-1 for none), start ns, end ns or None].
_spans: list = []
_open: list = []  # the entries of the spans open now, outermost first
_counters: collections.Counter = collections.Counter()
_launches: collections.Counter = collections.Counter()
_last: dict = {}  # counter name -> the value count_change was last given
_device: dict = {}  # device name -> (len(DEVICE_COUNTERS),) int64 tensor


class _Span:
    __slots__ = ("entry",)

    def __init__(self, name: str):
        parent = _open[-1][4] if _open else -1
        self.entry = [name, parent, 0, None, len(_spans)]

    def __enter__(self):
        _spans.append(self.entry)
        _open.append(self.entry)
        self.entry[2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.entry[3] = time.time_ns()
        if _open and _open[-1] is self.entry:
            _open.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the span ``name`` around its block while
    recording, nothing otherwise."""
    return _Span(name) if recording() else _OFF


def spanned(name: str):
    """A decorator: every call of the function is the span ``name`` while
    recording."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def wait(site: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, where the host waits for the card at
    ``site``: a read of device values (``.item()``, ``int(t)``,
    ``.tolist()``, ``.cpu()``, an index by a device scalar) or an upload of
    host values (a tensor made from host numbers, a copy from host
    memory)."""
    if not recording():
        return fn(*args, **kwargs)
    name = f"wait.{site}"
    _counters[name] += 1
    with _Span(name):
        return fn(*args, **kwargs)


def count(name: str) -> None:
    """Adds one to the host counter ``name`` (always)."""
    _counters[name] += 1


def count_change(name: str, value) -> None:
    """Adds one to the host counter ``name`` (always) when ``value``
    differs from the value last given under ``name`` (or none was)."""
    if name not in _last or _last[name] != value:
        _counters[name] += 1
        _last[name] = value


def launched(name: str, n: int = 1) -> None:
    """Counts ``n`` launches of the kernel wrapper ``name`` (always)."""
    _launches[name] += n


def launches(name: str) -> int:
    """The launches counted of the kernel wrapper ``name``."""
    return _launches[name]


def launch_counts() -> dict:
    """The launches counted of every kernel wrapper, by name."""
    return dict(_launches)


def device_counters(device):
    """The kernels' counters on ``device``, an int64 tensor of
    :data:`DEVICE_COUNTERS` that kernels add to with no host wait; None
    while not recording."""
    if not recording():
        return None
    key = str(torch.device(device))
    buf = _device.get(key)
    if buf is None:
        buf = _device[key] = torch.zeros(len(DEVICE_COUNTERS),
                                         dtype=torch.int64, device=device)
    return buf


def snapshot() -> dict:
    """What was recorded: ``spans``, a list of (name, parent, start ns,
    end ns) where parent is the index of the span open around it in the
    same list (-1 for none) and end is None while the span is open;
    ``counters``, the host counters and the kernels' counters summed over
    devices (the one read of the device buffers; a kernel counter that
    counted nothing is left out); ``launches``."""
    counters = dict(_counters)
    for buf in _device.values():
        for name, v in zip(DEVICE_COUNTERS, buf.tolist()):
            if v:
                counters[name] = counters.get(name, 0) + v
    return {"spans": [tuple(e[:4]) for e in _spans],
            "counters": counters, "launches": dict(_launches)}


def reset() -> None:
    """Clears the spans, the counters (and the values :func:`count_change`
    last saw) and the launches. The kernels' counters are zeroed where they
    are (no buffer is made again inside a later profiler window)."""
    _spans.clear()
    _open.clear()
    _counters.clear()
    _last.clear()
    _launches.clear()
    for buf in _device.values():
        buf.zero_()

"""Spans and counters at the port's layer boundaries.

Counters are plain integers, always on, like the kernels'
``KERNEL_LAUNCHES``: ``count(name, n)`` adds to them and ``counters()``
returns a copy. No counter reads a device tensor.

Spans are off by default. ``span(name)`` is then one check of the module
global ``SPANS`` and a shared no-op context. ``enabled(True)`` turns them
on, and a span then

* opens ``torch.profiler.record_function("tracer_torch:" + name)`` while a
  profiler runs, so that it lies in the trace on the clock of the card's
  kernels;
* otherwise adds its host-clock duration and self time (the duration less
  the durations of the spans opened inside it on the same thread) to
  ``totals()[name]``. Host-clock sums are never taken under a profiler,
  which slows host work.

The stack of open spans is per thread: the autograd engine runs the card's
backward on a thread of its own.

``host_read(site, t)`` is ``bool(t)``, counted as ``host_read.<site>`` and
wrapped in the span of that name: the host waiting for the device to
answer. ``reset()`` clears the counters and the totals.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

PREFIX = "tracer_torch:"
SPANS = False  # spans on; ``enabled`` sets it

_lock = threading.Lock()
_counts: dict = {}
_totals: dict = {}  # name -> [calls, total ns, self ns]
_local = threading.local()
_NOOP = contextlib.nullcontext()


class Totals(NamedTuple):
    calls: int
    total_ms: float
    self_ms: float


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
            return self
        self.rf = None
        stack = _local.__dict__.setdefault("stack", [])
        stack.append(self)
        self.child = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            return False
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        with _lock:
            row = _totals.setdefault(self.name, [0, 0, 0])
            row[0] += 1
            row[1] += dt
            row[2] += dt - self.child
        return False


def span(name: str):
    """A context for the layer ``name``: a no-op while spans are off."""
    if not SPANS:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def host_read(site: str, t) -> bool:
    """``bool(t)`` for a one-element device tensor ``t``: a blocking read,
    counted and spanned as ``host_read.<site>``."""
    name = "host_read." + site
    count(name)
    with span(name):
        return bool(t)


def enabled(flag: bool) -> None:
    """Turn spans on or off."""
    global SPANS
    SPANS = bool(flag)


def totals() -> dict:
    """{span name: Totals(calls, total ms, self ms)} on the host clock."""
    with _lock:
        return {k: Totals(c, t / 1e6, s / 1e6) for k, (c, t, s) in _totals.items()}


def counters() -> dict:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
        _totals.clear()

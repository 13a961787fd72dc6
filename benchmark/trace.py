"""The traced window: ``torch.profiler`` over it, and the reductions of its
trace that the per-layer readers and the result's ``breakdown`` take.

The benchmark's own host spans (``record_function``) mark the window,
each frame or step, and whatever a reader wraps (``span``); the device's
kernels, copies and sets come from CUPTI through the profiler. Times are
the profiler's, in microseconds on one clock for both.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "bench:"


@contextlib.contextmanager
def span(name: str):
    """A host span named ``bench:<name>`` in the trace."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Trace:
    """What the traced window left: device intervals by name, the
    benchmark's spans, the profiler's host operations, and the window."""

    window: tuple = (0.0, 0.0)  # (start, end) us
    device: list = field(default_factory=list)  # (name, start, end) us, kernels and copies
    spans: list = field(default_factory=list)  # (name, start, end) us, the benchmark's
    ops: list = field(default_factory=list)  # (name, start, end) us, host operations
    units: int = 0  # frames or steps traced

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        """Device intervals that are kernels (not copies or sets)."""
        return [k for k in self.device if not k[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> list:
        """The union of device intervals inside the window, merged."""
        lo, hi = self.window
        spans = sorted((max(a, lo), min(b, hi)) for _, a, b in self.device if b > lo and a < hi)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_us(self, key: str) -> float:
        """Device time of the kernels whose name holds ``key``."""
        return sum(b - a for n, a, b in self.device if key in n)

    def label(self, at: float) -> str:
        """The innermost benchmark span and outermost host operation open at
        time ``at``."""
        sp = [s for s in self.spans if s[1] <= at < s[2]]
        name = min(sp, key=lambda s: s[2] - s[1])[0] if sp else "window"
        ops = [o for o in self.ops if o[1] <= at < o[2]]
        if ops:
            name += "/" + max(ops, key=lambda o: o[2] - o[1])[0]
        return name

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time, and the ``n``
        longest idle gaps of the window with what the host was doing."""
        by_name: dict = {}
        for name, a, b in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = self.busy_intervals()
        gaps, prev = [], self.window[0]
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.window[1] > prev:
            gaps.append((prev, self.window[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[name[:200], us / 1e6] for name, us in top],
                "idle_gaps": [[self.label((a + b) / 2), (b - a) / 1e6] for a, b in gaps]}


@contextlib.contextmanager
def traced(trace: Trace):
    """Profile the body (CPU and CUDA activity) and fill ``trace``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            yield trace
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            # The device-side copies of host annotations are no device work.
            if not e.name.startswith(SPAN_PREFIX) and not getattr(e, "is_user_annotation", False):
                trace.device.append(iv)
        elif e.name == SPAN_PREFIX + "window":
            trace.window = iv[1:]
        elif e.name.startswith(SPAN_PREFIX):
            trace.spans.append((e.name[len(SPAN_PREFIX):],) + iv[1:])
        else:
            trace.ops.append(iv)

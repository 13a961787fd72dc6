"""The program's own spans in the traced window.

``tracer_torch.obs`` opens ``record_function("tracer_torch:<layer>")`` at
the port's layer boundaries while a profiler runs and spans are on. The
readers of ``metrics/_program.py`` turn them on for a traced run, put a
``ProgramTrace`` in the probe's place and observe the profiler that
``trace.traced`` starts, so that after the window

* the program's spans are in ``program``, not among the host operations
  (``ops``), and their device-side copies are not in ``device``: every
  other reader reads the lists it read before;
* each kernel of ``kernels()`` is attributed to the innermost program span
  open at its launch: the profiler gives a kernel and the runtime call that
  launched it (``cudaLaunchKernel``, ``cuLaunchKernel`` and the like) one
  correlation id. The span is looked for on the launching thread first and
  then on any thread, so that the autograd engine's launches count under
  the span that waits for them (``grad.backward``);
* an idle gap's label names the innermost program span between the
  benchmark's span and the host operation: ``frame/integrator.shade/aten::zeros``.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field

import torch

from benchmark import trace as tr

PREFIX = "tracer_torch:"
LAUNCHES = ("cudaLaunch", "cuLaunch")


def innermost(spans: list, times: list) -> list:
    """For each time of ``times``, the innermost of ``spans`` ((name, start,
    end), properly nested, as one thread's are) open at it, or None."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


@dataclass
class ProgramTrace(tr.Trace):
    """A ``trace.Trace`` with the program's spans taken apart."""

    program: list = field(default_factory=list)  # (name, start, end, thread) us
    kernel_spans: list = field(default_factory=list)  # per kernel: its launch's span or None
    unlinked: int = 0  # kernels whose launch the profiler did not give

    def take(self, events) -> None:
        """Take the program's spans and the kernels' launch spans from the
        profiler's ``events``, and the program's spans out of ``ops`` and
        ``device``."""
        cuda = torch.autograd.DeviceType.CUDA
        launch, kernels = {}, []
        for e in events:
            a, b = float(e.time_range.start), float(e.time_range.end)
            if e.device_type == cuda:
                if not (e.name.startswith((tr.SPAN_PREFIX, PREFIX, "Memcpy", "Memset"))
                        or getattr(e, "is_user_annotation", False)):
                    kernels.append(e.id)
            elif e.name.startswith(PREFIX):
                self.program.append((e.name[len(PREFIX):], a, b, e.thread))
            elif e.name.startswith(LAUNCHES):
                launch[e.id] = (a, e.thread)
        self.ops = [o for o in self.ops if not o[0].startswith(PREFIX)]
        self.device = [d for d in self.device if not d[0].startswith(PREFIX)]
        self.kernel_spans = self.attribute([launch.get(k) for k in kernels])
        self.unlinked = sum(k not in launch for k in kernels)

    def attribute(self, launches: list) -> list:
        """The name of the innermost program span at each launch ((time,
        thread), or None where the launch was not found): on the launching
        thread, else the shortest open on any thread."""
        by_thread: dict = {}
        for name, a, b, th in self.program:
            by_thread.setdefault(th, []).append((name, a, b))
        times = [x[0] if x else 0.0 for x in launches]
        found = {th: innermost(sp, times) for th, sp in by_thread.items()}
        out = []
        for i, x in enumerate(launches):
            s = found[x[1]][i] if x and x[1] in found else None
            if x and s is None:
                open_ = [f[i] for f in found.values() if f[i] is not None]
                s = min(open_, key=lambda s: s[2] - s[1]) if open_ else None
            out.append(s[0] if s else None)
        return out

    def launches_by_span(self) -> Counter:
        """Kernels by the program span open at their launch (None: none)."""
        return Counter(self.kernel_spans)

    def program_at(self, at: float):
        """The innermost program span open at ``at``, on any thread."""
        sp = [s for s in self.program if s[1] <= at < s[2]]
        return min(sp, key=lambda s: s[2] - s[1])[0] if sp else None

    def label(self, at: float) -> str:
        base = super().label(at)
        prog = self.program_at(at)
        if prog is None:
            return base
        head, sep, op = base.partition("/")
        return f"{head}/{prog}" + (f"/{op}" if sep else "")


def observing(traced, sink: list):
    """A ``make`` for ``Probe.wrap`` of ``trace.traced``: the original, with
    the profiler it starts kept in ``sink`` and, where the trace is a
    ``ProgramTrace``, the program's spans taken from its events."""
    @contextlib.contextmanager
    def run(trace):
        real = torch.profiler.profile

        class Kept(real):
            def __enter__(self):
                sink.append(self)
                return super().__enter__()

        torch.profiler.profile = Kept
        try:
            with traced(trace):
                torch.profiler.profile = real
                yield trace
        finally:
            torch.profiler.profile = real
        if sink and isinstance(trace, ProgramTrace):
            trace.take(sink[-1].events())
    return run

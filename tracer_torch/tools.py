"""Render statistics (port of ``tracer.tools``): ``RenderStats``, the
reference's ``RenderStats`` (``reference/src/tools.rs:4-62``) —
average, least and largest frame time over a window, printed every N
seconds. The caller synchronizes the device before ``end``."""

from __future__ import annotations

import sys
import time


class RenderStats:
    def __init__(self, print_every: float = 5.0):
        self.print_every = print_every
        self._times: list[float] = []
        self._window_start = time.perf_counter()
        self._t0 = 0.0
        self.total_frames = 0

    def begin(self) -> None:
        self._t0 = time.perf_counter()

    def end(self) -> None:
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self.total_frames += 1
        if self.print_every and time.perf_counter() - self._window_start >= self.print_every:
            print(f"[stats] {self.summary()}", file=sys.stderr, flush=True)
            self._times.clear()
            self._window_start = time.perf_counter()

    def summary(self) -> str:
        if not self._times:
            return "no frames"
        n = len(self._times)
        avg = sum(self._times) / n
        return (
            f"{n} frames: avg {avg * 1e3:.2f} ms, "
            f"min {min(self._times) * 1e3:.2f} ms, "
            f"max {max(self._times) * 1e3:.2f} ms"
        )

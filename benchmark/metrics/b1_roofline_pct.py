"""``b1_roofline_pct``: kernel B1's share of its roofline on one traced
frame: the least time of that frame's B1 calls (``counts/b1.py``, from
the arguments each call was handed, caught at ``kernels.super_hits.hits2``)
over B1's device time in that frame, in %. The frame is the second traced
one, the first whose flat-engine bounds start from the frame before."""

import torch

from benchmark.counts import b1

CAUGHT = "b1_calls"


def install(probe):
    from tracer_torch.kernels import super_hits

    frame = 1 if int(probe.trace_units) > 1 else 0

    def make(fn):
        def run(tb, *args):
            if probe.phase == "trace" and probe.unit_index == frame:
                probe.captured.setdefault(CAUGHT, []).append(
                    (tb.qblocks,) + tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(tb, *args)
        return run

    probe.wrap(super_hits, "hits2", make)
    probe.captured["b1_frame"] = frame


def read(probe):
    calls = probe.captured.get(CAUGHT)
    spans = probe.unit_spans
    frame = probe.captured.get("b1_frame", 0)
    if not calls or len(spans) <= frame:
        return None
    lo, hi = spans[frame]
    dev_us = sum(b - a for n, a, b in probe.trace.device
                 if "super_hits_kernel" in n and lo <= a < hi)
    if dev_us <= 0:
        return None
    least = sum(b1.least_ms(*call) for call in calls)
    return 100.0 * least / (dev_us / 1e3)

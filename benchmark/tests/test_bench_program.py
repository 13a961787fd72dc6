"""The readers of the program's own spans and counters (``metrics/_program.py``)
and ``program_trace.ProgramTrace``: the idle gaps' labels and the kernels'
attribution to the span open at their launch on a synthetic trace, the
other readers' numbers with and without the program's spans, and whole
traced runs on the CPU, with and without ``tracer_torch.obs``."""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_trace as pt, trace as tr
from benchmark.tests import tiny

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
MAIN, AUTOGRAD = 1, 2


def ev(name, a, b, device=CPU, id=0, thread=MAIN):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=device, id=id, thread=thread, is_user_annotation=False)


def synthetic():
    """The profiler's events of one frame: the program's spans on the main
    thread (a step holding a bounce holding the shading, then a backward
    whose kernels the autograd thread launches), five launches and their
    kernels, a copy, and one kernel whose launch is missing."""
    p = pt.PREFIX
    events = [
        ev(p + "progressive.step", 0, 100), ev(p + "integrator.bounce", 10, 60),
        ev(p + "integrator.shade", 20, 40), ev(p + "grad.backward", 70, 95),
        ev("aten::zeros", 21, 23), ev("cudaLaunchKernel", 21.5, 22, id=11),
        ev("cudaLaunchKernel", 5, 6, id=12), ev("cudaLaunchKernel", 45, 46, id=13),
        ev("cuLaunchKernelEx", 80, 81, id=14, thread=AUTOGRAD),
        ev("cudaLaunchKernel", 101, 102, id=15),
        ev("zeros_kernel", 30, 31, CUDA, 11), ev("fill_kernel", 32, 33, CUDA, 12),
        ev("super_hits_kernel", 50, 55, CUDA, 13), ev("bwd_kernel", 85, 90, CUDA, 14),
        ev("tail_kernel", 103, 104, CUDA, 15), ev("orphan_kernel", 105, 106, CUDA, 99),
        ev("Memcpy DtoH", 96, 97, CUDA, 16),
        # The device-side copy of a program annotation is no device work.
        ev(p + "integrator.shade", 30, 40, CUDA, 0),
    ]
    return events


def fill(trace, events):
    """What ``trace.traced`` keeps of ``events``."""
    for e in events:
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == CUDA:
            trace.device.append(iv)
        else:
            trace.ops.append(iv)
    trace.spans.append(("frame", 0.0, 110.0))
    trace.window, trace.units = (0.0, 110.0), 1
    return trace


def test_innermost_span_on_one_thread():
    spans = [("a", 0, 10), ("b", 2, 8), ("c", 3, 4), ("d", 5, 6), ("e", 12, 14)]
    got = pt.innermost(spans, [3.5, 1, 11, 5.5, 7, 13, 2])
    assert [s and s[0] for s in got] == ["c", "a", None, "d", "b", "e", "b"]


def test_kernels_attributed_to_the_span_open_at_their_launch():
    t = fill(pt.ProgramTrace(), synthetic())
    t.take(synthetic())
    assert [k[0] for k in t.kernels()] == ["zeros_kernel", "fill_kernel", "super_hits_kernel",
                                          "bwd_kernel", "tail_kernel", "orphan_kernel"]
    # The kernel ran after its span closed; its launch decides. The
    # autograd thread opened no span, so the main thread's backward holds it.
    assert t.kernel_spans == ["integrator.shade", "progressive.step", "integrator.bounce",
                              "grad.backward", None, None]
    assert t.unlinked == 1
    by = t.launches_by_span()
    assert sum(by.values()) == len(t.kernels())
    assert not any(o[0].startswith(pt.PREFIX) for o in t.ops + t.device)
    assert [s[0] for s in t.program] == ["progressive.step", "integrator.bounce",
                                         "integrator.shade", "grad.backward"]


def test_own_thread_span_before_another_threads():
    t = pt.ProgramTrace(program=[("grad.backward", 0, 100, MAIN),
                                 ("integrator.trace_closest", 10, 20, AUTOGRAD),
                                 ("integrator.bounce", 5, 15, MAIN)])
    assert t.attribute([(12, AUTOGRAD), (12, MAIN), (50, AUTOGRAD), None]) == [
        "integrator.trace_closest", "integrator.bounce", "grad.backward", None]


def test_idle_gap_label_names_the_program_span():
    t = fill(pt.ProgramTrace(), synthetic())
    t.take(synthetic())
    assert t.label(21.8) == "frame/integrator.shade/aten::zeros"
    assert t.label(50) == "frame/integrator.bounce"
    assert t.label(108) == "frame"
    assert tr.Trace.label(t, 21.8) == "frame/aten::zeros"


def _readers():
    names = ["launches_per_frame", "device_idle_pct.frame", "b1_ms.frame"]
    return {n: harness.load_reader(n) for n in names}


def test_other_readers_read_the_same_with_program_spans():
    events = synthetic()
    plain = fill(tr.Trace(), [e for e in events if not e.name.startswith(pt.PREFIX)])
    mine = fill(pt.ProgramTrace(), events)
    mine.take(events)
    for name, rd in _readers().items():
        a = rd.read(SimpleNamespace(trace=plain, unit="frame"))
        b = rd.read(SimpleNamespace(trace=mine, unit="frame"))
        assert a == b and a is not None, name
    assert plain.breakdown()["device_ops"] == mine.breakdown()["device_ops"]
    assert [g[1] for g in plain.breakdown()["idle_gaps"]] == [
        g[1] for g in mine.breakdown()["idle_gaps"]]


class Keep(harness.Probe):
    made: list = []

    def __init__(self, unit):
        super().__init__(unit)
        Keep.made.append(self)


def test_traced_run_reads_the_program_and_turns_spans_off(monkeypatch):
    from tracer_torch import obs

    monkeypatch.setattr(harness, "Probe", Keep)
    Keep.made.clear()
    res = tiny.run("bunny_path.frames", trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("host_reads_per_frame", "host_read_wait_ms.frame", "shade_self_ms.frame",
                 "bounces_per_frame", "phase_a_self_ms.frame", "phase_a_iters_per_frame"):
        assert m[name]["value"] > 0, name
    # No device on the CPU: no launches are read.
    assert "phase_a_launches_per_frame" not in m
    assert m["phase_a_self_ms.frame"]["value"] <= m["phase_a_ms.frame"]["value"]
    assert obs.SPANS is False
    trace = Keep.made[-1].trace
    names = {s[0] for s in trace.program}
    assert {"progressive.step", "integrator.bounce", "packet.phase_a",
            "host_read.packet.walk"} <= names
    assert not any(o[0].startswith(pt.PREFIX) for o in trace.ops)


def test_traced_run_without_the_programs_spans(monkeypatch):
    """A program without ``tracer_torch.obs``: the new readers say nothing,
    the others read as before."""
    import tracer_torch.diff.grad  # noqa: F401  (the program, loaded before ``obs`` goes)

    monkeypatch.setitem(sys.modules, "tracer_torch.obs", None)
    res = tiny.run("dragon.grad", trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"build_s"}


@pytest.mark.parametrize("name,want", [
    ("dragon.frames", {"host_reads_per_frame", "host_read_wait_ms.frame",
                       "shade_self_ms.frame", "cull_self_ms.frame"}),
    ("dragon.grad", {"host_reads_per_step", "grad_forward_ms.step", "grad_backward_ms.step"}),
])
def test_traced_run_reads_its_cells_metrics(name, want):
    res = tiny.run(name, trace=True)
    assert res["correct"], res["checks"]
    assert want <= set(res["metrics"]), res["metrics"]
    assert all(res["metrics"][n]["value"] > 0 for n in want)

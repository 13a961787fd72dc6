"""Shared arithmetic of the readers that take the program's own spans and
counters (``tracer_torch.obs``).

``install`` turns the program's spans on for both windows of a traced
run (untraced runs never turn them on), clears its tables, and puts a
``program_trace.ProgramTrace`` in the probe's place, so that the traced
window's kernels are attributed to the program span open at their launch.
A program without ``tracer_torch.obs`` has none of this: the readers then
find nothing and return None.

* Span readers take host-clock sums over the untraced first window, per
  frame or step of it (the profiler slows host work, so the traced window
  records its spans in the trace instead).
* Counter readers take the counters' change since ``install``, per frame
  or step of both windows.
* Launch readers take the traced window's kernels by the span open at
  their launch, per traced frame or step.
"""

import importlib

from benchmark import program_trace, trace as tr

KEY = "program"


def install(probe) -> None:
    if KEY in probe.captured:
        return
    try:
        obs = importlib.import_module("tracer_torch.obs")
    except ImportError:
        probe.captured[KEY] = None
        return
    obs.reset()
    probe.captured[KEY] = {"obs": obs, "counters": obs.counters()}
    probe.wrap(obs, "SPANS", lambda was: True)
    probe.trace = program_trace.ProgramTrace()
    probe.wrap(tr, "traced", lambda traced: program_trace.observing(traced, []))


def _obs(probe):
    got = probe.captured.get(KEY)
    return got["obs"] if got else None


def span_ms(probe, names, self_time: bool = False):
    """Host ms per unit of the untraced window inside the spans ``names``
    (their totals, or their self times); None where none ran."""
    obs = _obs(probe)
    if obs is None or not probe.host_units:
        return None
    rows = [t for n, t in obs.totals().items() if n in names]
    if not rows:
        return None
    return sum(t.self_ms if self_time else t.total_ms for t in rows) / probe.host_units


def counted(probe, names):
    """The counters ``names`` added since ``install``, per unit of both
    windows; None where the program has none of them."""
    obs = _obs(probe)
    units = probe.host_units + probe.trace.units
    if obs is None or not units:
        return None
    now, then = obs.counters(), probe.captured[KEY]["counters"]
    if not any(n in now for n in names):
        return None
    return sum(now.get(n, 0) - then.get(n, 0) for n in names) / units


def host_reads(probe) -> list:
    """The names of the host reads' counters (and spans) the program has."""
    obs = _obs(probe)
    if obs is None:
        return []
    return [n for n in obs.counters() if n.startswith("host_read.")]


def launches(probe, name: str):
    """Kernels launched inside the program span ``name`` (innermost), per
    traced unit; None where nothing was traced or the span never opened."""
    t = probe.trace
    if (_obs(probe) is None or not t.units or not t.device
            or not isinstance(t, program_trace.ProgramTrace)):
        return None
    if not any(s[0] == name for s in t.program):
        return None
    return t.launches_by_span()[name] / t.units

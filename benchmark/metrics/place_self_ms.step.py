"""``place_self_ms.step``: host-clock ms per gradient step in the placement
of the hit rows' cotangents (``grad.place``: ``fetch_tri_rows``' backward,
the sort and kernel B2's launch, on the autograd engine's thread), self
time, over the traced run's untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"grad.place"}, self_time=True)

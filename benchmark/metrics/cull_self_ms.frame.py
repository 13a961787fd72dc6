"""``cull_self_ms.frame``: host-clock ms per frame in the flat engine's cull,
order and gates (``flat.emissions``), over the traced run's untraced
window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"flat.emissions"}, self_time=True)

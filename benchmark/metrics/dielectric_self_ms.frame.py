"""``dielectric_self_ms.frame``: host-clock ms per frame in the path-mode
dielectric (``integrator.dielectric``), its self time, over the traced
run's untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"integrator.dielectric"}, self_time=True)

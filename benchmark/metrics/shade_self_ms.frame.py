"""``shade_self_ms.frame``: host-clock ms per frame in the shading
(``integrator.shade``) less the spans inside it (the shadow rays'
``integrator.trace_occluded``), over the traced run's untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"integrator.shade"}, self_time=True)

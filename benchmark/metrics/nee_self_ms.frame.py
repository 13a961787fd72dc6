"""``nee_self_ms.frame``: host-clock ms per frame in the path Lambertian's
area-light estimate (``integrator.nee``: the sample, the shadow ray and the
contribution) less the spans inside it (the shadow ray's
``integrator.trace_occluded``), over the traced run's untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"integrator.nee"}, self_time=True)

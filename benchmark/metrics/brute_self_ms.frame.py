"""``brute_self_ms.frame``: host-clock ms per frame in the brute-force
engine's two queries (``brute.closest``, ``brute.occluded``), their self
times, over the traced run's untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"brute.closest", "brute.occluded"}, self_time=True)

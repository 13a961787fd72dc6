"""``phase_a_self_ms.frame``: host-clock ms per frame in packet phase A
(``packet.phase_a``, each ``_phase_a_chunk`` call) less its blocking reads
of the walk's condition, over the traced run's untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"packet.phase_a"}, self_time=True)

"""``grad_forward_ms.step``: host-clock ms per gradient step in the forward
render and loss (``grad.forward``), over the traced run's untraced
window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"grad.forward"})

"""``grad_backward_ms.step``: host-clock ms per gradient step in
``torch.autograd.grad`` (``grad.backward``), over the traced run's
untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, {"grad.backward"})

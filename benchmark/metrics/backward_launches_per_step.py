"""``backward_launches_per_step``: kernels launched per traced step inside
``torch.autograd.grad`` (``grad.backward``; the autograd engine's thread
launches them while the span is open)."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.launches(probe, "grad.backward")

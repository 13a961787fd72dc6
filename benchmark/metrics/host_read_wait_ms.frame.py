"""``host_read_wait_ms.frame``: host-clock ms per frame that the host waits
in its blocking reads of device tensors (the ``host_read.*`` spans of
``tracer_torch.obs``), over the traced run's untraced window."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.span_ms(probe, _program.host_reads(probe))

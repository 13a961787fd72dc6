"""``host_reads_per_step``: blocking reads of a device tensor by the host
(``tracer_torch.obs.host_read``) per gradient step of both windows of a
traced run."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, _program.host_reads(probe))

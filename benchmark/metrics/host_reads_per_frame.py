"""``host_reads_per_frame``: blocking reads of a device tensor by the host
(``tracer_torch.obs.host_read``: the bounce loop's done mask, the seeded
repair, the overflow sweep, phase A's walk and rounds) per frame of both
windows of a traced run."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, _program.host_reads(probe))

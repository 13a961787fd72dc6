"""``bounces_per_frame``: bounces of the wavefront (``integrator.bounces``:
the single bounce, or each iteration of the bounce loop) per frame of
both windows of a traced run."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["integrator.bounces"])

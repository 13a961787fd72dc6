"""``cull_launches_per_frame``: kernels launched per traced frame with the
flat engine's cull, order and gates (``flat.emissions``) the innermost
program span."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.launches(probe, "flat.emissions")

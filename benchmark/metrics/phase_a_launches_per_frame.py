"""``phase_a_launches_per_frame``: kernels launched per traced frame with
packet phase A (``packet.phase_a``) the innermost program span."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.launches(probe, "packet.phase_a")

"""``phase_a_iters_per_frame``: iterations of packet phase A's top-tree walk
(``packet.phase_a_iterations``, counted per batch of ``CHECK_EVERY``) per
frame of both windows of a traced run."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["packet.phase_a_iterations"])

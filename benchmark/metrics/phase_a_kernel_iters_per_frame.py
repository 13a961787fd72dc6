"""``phase_a_kernel_iters_per_frame``: packet phase A's walk iterations run
by the walk kernel (``packet.phase_a_kernel_iterations``, counted by ``n``
per launch, replayed from the graph or launched directly) per frame of both
windows of a traced run. Equal to ``phase_a_iters_per_frame`` where every
iteration on the card runs the kernel. A program without the kernel counts
none, and the reader then returns None."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["packet.phase_a_kernel_iterations"])

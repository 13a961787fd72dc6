"""``phase_a_graph_replays_per_frame``: replays of packet phase A's CUDA
graph of ``CHECK_EVERY`` walk iterations (``packet.phase_a_graph_replays``)
per frame of both windows of a traced run. A program without the graph
counts none, and the reader then returns None."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["packet.phase_a_graph_replays"])

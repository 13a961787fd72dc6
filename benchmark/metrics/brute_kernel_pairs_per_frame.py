"""``brute_kernel_pairs_per_frame``: (ray, triangle) pairs the brute-force
engine's kernel tests (``brute.kernel_pairs``, rays times triangles per
launch, replayed from the bounce's graph or launched directly) per frame of
both windows of a traced run. Equal to ``brute_pairs_per_frame`` where every
query on the card runs the kernel. A program without the kernel counts
none, and the reader then returns None."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["brute.kernel_pairs"])

"""``brute_pairs_per_frame``: (ray, triangle) pairs the brute-force engine
tests (``brute.pairs``: rays times triangles per query, from the shapes)
per frame of both windows of a traced run; the count a roofline of the
engine divides, whatever implements it."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["brute.pairs"])

"""``b2_rows_per_step``: corner rows kernel B2 places per gradient step
(``scatter_vn.rows``, added from the shapes at each call of
``kernels.scatter_vn.segment_place``), over both windows of a traced run. A
program without the counter counts none, and the reader then returns
None."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["scatter_vn.rows"])

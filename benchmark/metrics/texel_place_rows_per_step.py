"""``texel_place_rows_per_step``: texel rows the texel-cotangent placement
places per gradient step (``texel_place.rows``, added from the shapes at
each call of ``kernels.texel_place.place``: taps x lanes a lookup), over
both windows of a traced run. A program without the counter counts none,
and the reader then returns None."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    return _program.counted(probe, ["texel_place.rows"])

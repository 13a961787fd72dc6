"""``held_gib.step``: device memory the forward leaves allocated for the
backward per gradient step (``grad.held_bytes``: ``memory_allocated`` after
the forward less before it, on the host's allocator counters), in GiB, over
both windows of a traced run. A program without the counter counts none,
and the reader then returns None."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    held = _program.counted(probe, ["grad.held_bytes"])
    return None if held is None else held / 2 ** 30

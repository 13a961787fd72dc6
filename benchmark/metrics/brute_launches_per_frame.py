"""``brute_launches_per_frame``: kernels launched per traced frame with
either of the brute-force engine's queries (``brute.closest``,
``brute.occluded``) the innermost program span."""

from benchmark.metrics import _program


def install(probe):
    _program.install(probe)


def read(probe):
    got = [n for n in (_program.launches(probe, s) for s in ("brute.closest", "brute.occluded"))
           if n is not None]
    return sum(got) if got else None

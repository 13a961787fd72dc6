"""``b2_roofline_pct.step``: kernel B2's share of its roofline per gradient
step: the least time of the step's placements (``counts/b2.py``, from the
counters ``scatter_vn.rows`` and ``scatter_vn.out_rows`` per step of both
windows) over the device time of B2's two passes (``_sums_kernel``) per
traced step, in %. The rows a step places do not change from step to step
(each step renders the same frame counter). None where the program has no
such counters or nothing was traced."""

from benchmark.counts import b2
from benchmark.metrics import _device, _program


def install(probe):
    _program.install(probe)


def read(probe):
    rows = _program.counted(probe, ["scatter_vn.rows"])
    out_rows = _program.counted(probe, ["scatter_vn.out_rows"])
    device_ms = _device.per_unit_ms(probe, "_sums_kernel")
    if rows is None or out_rows is None or device_ms is None:
        return None
    return 100.0 * b2.least_ms(rows, out_rows) / device_ms

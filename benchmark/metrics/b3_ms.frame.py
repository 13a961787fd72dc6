"""``b3_ms.frame``: device ms per traced frame of kernel B3
(``kernels.treelet_hits``, ``treelet_hits_kernel``)."""

from benchmark.metrics import _device


def read(probe):
    return _device.per_unit_ms(probe, "treelet_hits_kernel")

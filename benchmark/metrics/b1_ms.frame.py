"""``b1_ms.frame``: device ms per traced frame of kernel B1
(``kernels.super_hits``, ``super_hits_kernel``)."""

from benchmark.metrics import _device


def read(probe):
    return _device.per_unit_ms(probe, "super_hits_kernel")

"""``anyhit_ms.frame``: device ms per traced frame of the any-hit query's
kernel (``kernels.super_occluded``, ``super_occluded_kernel``)."""

from benchmark.metrics import _device


def read(probe):
    return _device.per_unit_ms(probe, "super_occluded_kernel")

"""``b2_ms.step``: device ms per traced step of kernel B2's two passes
(``kernels.scatter_vn``: ``chunk_sums_kernel`` and ``span_sums_kernel``)."""

from benchmark.metrics import _device


def read(probe):
    return _device.per_unit_ms(probe, "_sums_kernel")

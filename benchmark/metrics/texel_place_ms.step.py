"""``texel_place_ms.step``: device ms per traced step of the texel-cotangent
placement's two passes (``kernels.texel_place``: ``texel_place_chunk_kernel``
and ``texel_place_span_kernel``), the backward of the texture lookups'
texel gathers. None where no such kernel ran, as in a program that leaves
that backward to PyTorch's index backward."""

from benchmark.metrics import _device


def read(probe):
    return _device.per_unit_ms(probe, "texel_place_")

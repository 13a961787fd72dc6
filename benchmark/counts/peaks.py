"""The card's peaks and the least time of a piece of work, frozen.

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W (the rates
``chip_smoke.py`` uses as of commit 571a042): device memory 3.35 TB/s,
float32 outside the tensor cores 67 TFLOP/s. ``least_ms`` is
``chip_smoke.bound_ms``: the larger of the bytes over the memory rate and
the operations over the float32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_ms(n_bytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds for the work, "bytes" or "operations")."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

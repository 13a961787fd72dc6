"""The work of kernel B2's placement (``kernels.scatter_vn.segment_place``),
frozen.

A copy of ``chip_smoke.py``'s bound on one B2 call as of commit 6899c28
(``b2_bound_ms``): each placed row's int32 vertex id and six float32
cotangents read once, each of the V output rows' six float32 sums written
once, and six float32 additions a placed row, over the card's peaks.
"""

from __future__ import annotations

from benchmark.counts import peaks

ROW_BYTES = 4 + 24  # an int32 id and six float32 cotangents, read
OUT_ROW_BYTES = 24  # six float32 sums, written
OPS_PER_ROW = 6


def least_ms(rows: float, out_rows: float) -> float:
    """The least milliseconds for placing ``rows`` rows into ``out_rows``
    output rows on the card's peaks. Bytes bound B2, so a sum of calls'
    rows and output rows gives the sum of the calls' least times."""
    return peaks.least_ms(rows * ROW_BYTES + out_rows * OUT_ROW_BYTES, rows * OPS_PER_ROW)[0]

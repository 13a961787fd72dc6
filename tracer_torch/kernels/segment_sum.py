"""The Python side of ``tracer_torch/csrc/segment_sum.cuh``, the sorted
segmented sum that the placement kernels share: B2 (``scatter_vn``, vertex
cotangents, rows of 6) and ``texel_place`` (texel cotangents, rows of 4).

* ``launch`` — the checks, allocations and ctypes call around a kernel's C
  entry point, which each wrapper builds from its own source.
* ``chunk_order_sum`` — the kernels' fixed order of additions in plain
  PyTorch, which each wrapper's twin runs: the stream cut into chunks of
  ``chunk_rows`` rows, each id's rows within a chunk summed in stream order
  from 0.0, then each id's chunk partials in chunk order from 0.0.
"""

from __future__ import annotations

import torch

from tracer_torch._build import CSRC

HEADERS = (CSRC / "segment_sum.cuh",)
# The chunk lengths the header's launch compiles (256, each wrapper's
# CHUNK_ROWS, and 32 and 512, which the card tests run); any other is refused.
KERNEL_CHUNK_ROWS = (32, 256, 512)


def launch(name: str, fn, sids: torch.Tensor, svals: torch.Tensor, n: int, cols: int,
           chunk_rows: int) -> torch.Tensor:
    """Check the arguments of a placement kernel (the header's ``launch``
    behind the C entry point ``fn``: ids (M,) int32, payload (M, cols)
    float32 on one device, ``chunk_rows`` one of ``KERNEL_CHUNK_ROWS``),
    allocate its (n, cols) output and the chunk partials, and launch it on
    the current stream; raises ValueError on what it cannot take and RuntimeError on a
    failed launch. ``name`` prefixes the messages."""
    M = sids.shape[0]
    if sids.dtype != torch.int32 or sids.ndim != 1:
        raise ValueError(f"{name}: ids must be (M,) int32, got {tuple(sids.shape)} {sids.dtype}")
    if svals.dtype != torch.float32 or svals.shape != (M, cols):
        raise ValueError(f"{name}: payload must be ({M}, {cols}) float32, "
                         f"got {tuple(svals.shape)} {svals.dtype}")
    if sids.device != svals.device:
        raise ValueError(f"{name}: ids on {sids.device}, payload on {svals.device}")
    if n < 0:
        raise ValueError(f"{name}: {n} output rows")
    if chunk_rows not in KERNEL_CHUNK_ROWS:
        raise ValueError(f"{name}: the kernel is built for chunks of {KERNEL_CHUNK_ROWS} "
                         f"rows, not {chunk_rows}")
    ids = sids.contiguous()
    vals = svals.contiguous()
    if vals.data_ptr() % 16:
        vals = vals.clone()  # a fresh allocation: the kernel loads 16 bytes at a time
    out = torch.empty((n, cols), dtype=torch.float32, device=svals.device)
    n_chunks = max(1, -(-M // chunk_rows))
    head = torch.empty((n_chunks, cols), dtype=torch.float32, device=svals.device)
    tail = torch.empty_like(head)
    with torch.cuda.device(svals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ids.data_ptr(), vals.data_ptr(), out.data_ptr(), head.data_ptr(),
                 tail.data_ptr(), M, n, chunk_rows, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    return out


def chunk_order_sum(sids: torch.Tensor, svals: torch.Tensor, n: int,
                    chunk_rows: int) -> torch.Tensor:
    """Dense (n, C) sum of a sorted (id, row) stream in the kernels' fixed
    order: the twins' arithmetic.

    The first ``index_add_`` places the rows into one partial per (id,
    chunk of ``chunk_rows`` rows) pair, numbered in stream order; the second
    places the partials into the table. On the CPU each adds in index order
    from 0.0, which is the kernels' order.
    """
    ids = sids.long()
    M, dev = ids.shape[0], svals.device
    chunk = torch.arange(M, device=dev) // chunk_rows
    first = torch.ones(M, dtype=torch.bool, device=dev)
    first[1:] = (ids[1:] != ids[:-1]) | (chunk[1:] != chunk[:-1])
    partial = torch.cumsum(first, 0) - 1
    n_part = int(first.sum())
    parts = torch.zeros((n_part, svals.shape[1]), dtype=svals.dtype, device=dev)
    parts.index_add_(0, partial, svals)
    out = torch.zeros((n, svals.shape[1]), dtype=svals.dtype, device=dev)
    return out.index_add_(0, ids[first], parts)

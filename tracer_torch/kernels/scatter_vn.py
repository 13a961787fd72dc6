"""Vertex-cotangent placement: the CUDA kernel and its plain-PyTorch twin.

Port of the Pallas TPU kernel ``tracer.kernels.scatter_vn.segment_place``
and of ``scatter_add_vn_pallas``, which the backward of
``tracer_torch.geometry.device.fetch_tri_rows`` calls: the (3N, 6) corner
cotangents of the hit-attribute fetch are sorted by vertex id and summed
into a dense (V, 6) table (vertex xyz, normal xyz).

* ``segment_place`` — the entry point. For CUDA tensors it launches the
  hand-written kernel ``tracer_torch/csrc/scatter_vn.cu`` (built with
  ``nvcc`` for ``sm_90a`` at first use, bound with ctypes) or raises; for
  CPU tensors it runs ``segment_place_reference``. It never falls back from
  CUDA to the twin.
* ``segment_place_reference`` — the same sum in the kernel's fixed order
  (see ``segment_place``) as two ``index_add_`` calls. On the CPU
  ``index_add_`` adds in index order, so the twin agrees with the kernel
  bit for bit; on the card it adds with atomics in no fixed order.

``KERNEL_LAUNCHES`` counts kernel launches and ``REFERENCE_CALLS`` calls of
the twin, so a run can show which one served it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch._build import CSRC, nvcc_command, shared_library

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

SOURCE = CSRC / "scatter_vn.cu"
COLS = 6  # vertex xyz + normal xyz cotangents
# Rows per chunk of the fixed summation order; the kernel takes it as an
# argument (one CTA thread per row) and also accepts 32 and 512, which the
# card tests run.
CHUNK_ROWS = 256


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register and shared-memory use)."""
    path, log = shared_library("scatter_vn", nvcc_command(), [SOURCE])
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.segment_place_launch.restype = ctypes.c_int
    lib.segment_place_launch.argtypes = [ptr] * 5 + [i64, i64, ctypes.c_int, ptr]
    return lib, log


def segment_place(sids: torch.Tensor, svals: torch.Tensor, V: int) -> torch.Tensor:
    """Dense (V, 6) segment sum of a SORTED (id, payload) stream.

    sids: (M,) int32 ascending vertex ids in [0, V); svals: (M, 6) float32
    payload rows. Returns the (V, 6) float32 per-vertex sums; vertices that
    no row names get 0. The order of the additions is fixed: the stream is
    cut into chunks of ``CHUNK_ROWS`` rows, each vertex's rows within a
    chunk are summed in stream order from 0.0, and a vertex's result is its
    chunk partials summed in chunk order from 0.0.
    """
    if svals.device.type == "cpu":
        return segment_place_reference(sids, svals, V)
    if svals.device.type != "cuda":
        raise RuntimeError(f"scatter_vn: unsupported device {svals.device}")
    global KERNEL_LAUNCHES
    M = sids.shape[0]
    if sids.dtype != torch.int32 or sids.ndim != 1:
        raise ValueError(f"scatter_vn: ids must be (M,) int32, got {tuple(sids.shape)} {sids.dtype}")
    if svals.dtype != torch.float32 or svals.shape != (M, COLS):
        raise ValueError(f"scatter_vn: payload must be ({M}, {COLS}) float32, "
                         f"got {tuple(svals.shape)} {svals.dtype}")
    if sids.device != svals.device:
        raise ValueError(f"scatter_vn: ids on {sids.device}, payload on {svals.device}")
    if V < 0:
        raise ValueError(f"scatter_vn: V = {V}")
    ids = sids.contiguous()
    vals = svals.contiguous()
    if vals.data_ptr() % 16:
        vals = vals.clone()  # a fresh allocation: the kernel loads 16 bytes at a time
    out = torch.empty((V, COLS), dtype=torch.float32, device=svals.device)
    n_chunks = max(1, -(-M // CHUNK_ROWS))
    head = torch.empty((n_chunks, COLS), dtype=torch.float32, device=svals.device)
    tail = torch.empty_like(head)
    lib, _ = build()
    with torch.cuda.device(svals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segment_place_launch(ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                                       head.data_ptr(), tail.data_ptr(), M, V,
                                       CHUNK_ROWS, stream)
    if err != 0:
        raise RuntimeError(f"scatter_vn: kernel launch failed (cudaError {err})")
    KERNEL_LAUNCHES += 1
    return out


def segment_place_reference(sids: torch.Tensor, svals: torch.Tensor, V: int) -> torch.Tensor:
    """Plain-PyTorch twin of ``segment_place``: same arguments, same sums.

    The first ``index_add_`` places the rows into one partial per (vertex,
    chunk of ``CHUNK_ROWS`` rows) pair, numbered in stream order; the second
    places the partials into the (V, 6) table. On the CPU each adds in index
    order from 0.0, which is the kernel's order.
    """
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    ids = sids.long()
    M, dev = ids.shape[0], svals.device
    chunk = torch.arange(M, device=dev) // CHUNK_ROWS
    first = torch.ones(M, dtype=torch.bool, device=dev)
    first[1:] = (ids[1:] != ids[:-1]) | (chunk[1:] != chunk[:-1])
    partial = torch.cumsum(first, 0) - 1
    n_part = int(first.sum())
    parts = torch.zeros((n_part, svals.shape[1]), dtype=svals.dtype, device=dev)
    parts.index_add_(0, partial, svals)
    out = torch.zeros((V, svals.shape[1]), dtype=svals.dtype, device=dev)
    return out.index_add_(0, ids[first], parts)


def scatter_add_vn(flat_idx: torch.Tensor, flat_g: torch.Tensor, V: int) -> torch.Tensor:
    """(M,) vertex ids + (M, 6) cotangents -> (V, 6) sums, with no scatter:
    a stable sort by id (so each vertex's rows keep their stream order),
    then ``segment_place``."""
    sids, perm = torch.sort(flat_idx.to(torch.int32), stable=True)
    return segment_place(sids, flat_g.to(torch.float32)[perm], V)

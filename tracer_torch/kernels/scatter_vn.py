"""Vertex-cotangent placement: the CUDA kernel and its plain-PyTorch twin.

Port of the Pallas TPU kernel ``tracer.kernels.scatter_vn.segment_place``
and of ``scatter_add_vn_pallas``, which the backward of
``tracer_torch.geometry.device.fetch_tri_rows`` calls: the (3N, 6) corner
cotangents of the hit-attribute fetch are sorted by vertex id and summed
into a dense (V, 6) table (vertex xyz, normal xyz).

* ``segment_place`` — the entry point. For CUDA tensors it launches the
  hand-written kernel ``tracer_torch/csrc/scatter_vn.cu`` (the two passes
  of ``csrc/segment_sum.cuh`` at a row width of 6; built with
  ``nvcc`` for ``sm_90a`` at first use, bound with ctypes) or raises; for
  CPU tensors it runs ``segment_place_reference``. It never falls back from
  CUDA to the twin.
* ``segment_place_reference`` — the same sum in the kernel's fixed order
  (see ``segment_place``) as two ``index_add_`` calls. On the CPU
  ``index_add_`` adds in index order, so the twin agrees with the kernel
  bit for bit; on the card it adds with atomics in no fixed order.

``KERNEL_LAUNCHES`` counts kernel launches and ``REFERENCE_CALLS`` calls of
the twin, so a run can show which one served it. Each call of
``segment_place``, on either device, adds the rows it places and the rows
of the table it writes (V) to the counters ``scatter_vn.rows`` and
``scatter_vn.out_rows`` (``tracer_torch.obs``), from the shapes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch import obs
from tracer_torch._build import CSRC, nvcc_command, shared_library
from tracer_torch.kernels import segment_sum

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

SOURCE = CSRC / "scatter_vn.cu"
COLS = 6  # vertex xyz + normal xyz cotangents
# Rows per chunk of the fixed summation order (one CTA thread per row); one
# of segment_sum.KERNEL_CHUNK_ROWS, the lengths the kernel is compiled for.
CHUNK_ROWS = 256


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register and shared-memory use)."""
    path, log = shared_library("scatter_vn", nvcc_command(), [SOURCE],
                               headers=segment_sum.HEADERS)
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
    obs.count("scatter_vn.rows", int(sids.shape[0]))
    obs.count("scatter_vn.out_rows", int(V))
    if svals.device.type == "cpu":
        return segment_place_reference(sids, svals, V)
    if svals.device.type != "cuda":
        raise RuntimeError(f"scatter_vn: unsupported device {svals.device}")
    global KERNEL_LAUNCHES
    out = segment_sum.launch("scatter_vn", build()[0].segment_place_launch, sids, svals, V,
                             COLS, CHUNK_ROWS)
    KERNEL_LAUNCHES += 1
    return out


def segment_place_reference(sids: torch.Tensor, svals: torch.Tensor, V: int) -> torch.Tensor:
    """Plain-PyTorch twin of ``segment_place``: same arguments, same sums
    (``segment_sum.chunk_order_sum`` at ``CHUNK_ROWS``)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    return segment_sum.chunk_order_sum(sids, svals, V, CHUNK_ROWS)


def scatter_add_vn(flat_idx: torch.Tensor, flat_g: torch.Tensor, V: int) -> torch.Tensor:
    """(M,) vertex ids + (M, 6) cotangents -> (V, 6) sums, with no scatter:
    a stable sort by id (so each vertex's rows keep their stream order),
    then ``segment_place``."""
    sids, perm = torch.sort(flat_idx.to(torch.int32), stable=True)
    return segment_place(sids, flat_g.to(torch.float32)[perm], V)

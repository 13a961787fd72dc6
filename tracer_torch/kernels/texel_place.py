"""Texel-cotangent placement: the CUDA kernel and its plain-PyTorch twin.

The backward of the texture lookups' texel gathers
(``tracer_torch.render.texture._GatherTexels``): the (M, 4) cotangents of
the gathered texel rows, sorted by flat texel id, are summed into a dense
(H * W, 4) table. The JAX package has no Pallas kernel for it (XLA takes
the gathers' backward); PyTorch's backward of an index gather sums each
texel's duplicates in one serial loop, which the W9 E1 path gradient's
crowded lookups turned into most of its step (``csrc/texel_place.cu``).

* ``place`` — the entry point. For CUDA tensors it launches the
  hand-written kernel ``tracer_torch/csrc/texel_place.cu`` (B2's two passes
  of ``csrc/segment_sum.cuh`` at a row width of 4; built with ``nvcc`` for
  ``sm_90a`` at first use, bound with ctypes) or raises; for CPU tensors it
  runs ``place_reference``. It never falls back from CUDA to the twin.
* ``place_reference`` — the same sum in the kernel's fixed order as two
  ``index_add_`` calls (``segment_sum.chunk_order_sum``, as B2's twin, at
  this module's ``CHUNK_ROWS``). On the CPU ``index_add_`` adds in index
  order, so the twin agrees with the kernel bit for bit.

``KERNEL_LAUNCHES`` counts kernel launches and ``REFERENCE_CALLS`` calls of
the twin. Each call of ``place``, on either device, adds the rows it places
and the rows of the table it writes to the counters ``texel_place.rows``
and ``texel_place.out_rows`` (``tracer_torch.obs``), from the shapes. B2's
counters (``scatter_vn.rows``) count vertex corners only.
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

SOURCE = CSRC / "texel_place.cu"
COLS = 4  # a texel's four channels (an RGBE map's exponent included)
# Rows per chunk of the fixed summation order (one CTA thread per row); one
# of segment_sum.KERNEL_CHUNK_ROWS, the lengths the kernel is compiled for.
CHUNK_ROWS = 256


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register and shared-memory use)."""
    path, log = shared_library("texel_place", nvcc_command(), [SOURCE],
                               headers=segment_sum.HEADERS)
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.texel_place_launch.restype = ctypes.c_int
    lib.texel_place_launch.argtypes = [ptr] * 5 + [i64, i64, ctypes.c_int, ptr]
    return lib, log


def place(sids: torch.Tensor, rows: torch.Tensor, n_texels: int) -> torch.Tensor:
    """Dense (n_texels, 4) segment sum of a SORTED (texel id, row) stream.

    sids: (M,) int32 ascending flat texel ids in [0, n_texels); rows: (M, 4)
    float32 cotangent rows. Returns the (n_texels, 4) float32 per-texel
    sums; texels that no row names get 0. The order of the additions is
    fixed: the stream is cut into chunks of ``CHUNK_ROWS`` rows, each
    texel's rows within a chunk are summed in stream order from 0.0, and a
    texel's result is its chunk partials summed in chunk order from 0.0.
    """
    obs.count("texel_place.rows", int(sids.shape[0]))
    obs.count("texel_place.out_rows", int(n_texels))
    if rows.device.type == "cpu":
        return place_reference(sids, rows, n_texels)
    if rows.device.type != "cuda":
        raise RuntimeError(f"texel_place: unsupported device {rows.device}")
    global KERNEL_LAUNCHES
    out = segment_sum.launch("texel_place", build()[0].texel_place_launch, sids, rows,
                             n_texels, COLS, CHUNK_ROWS)
    KERNEL_LAUNCHES += 1
    return out


def place_reference(sids: torch.Tensor, rows: torch.Tensor, n_texels: int) -> torch.Tensor:
    """Plain-PyTorch twin of ``place``: same arguments, same sums."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    return segment_sum.chunk_order_sum(sids, rows, n_texels, CHUNK_ROWS)

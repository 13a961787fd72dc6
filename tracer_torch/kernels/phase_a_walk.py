"""Packet phase A's walk iterations as one CUDA kernel.

``walk(wk, n)`` runs ``n`` iterations of the top-tree walk for every tile of
a chunk in one launch of ``tracer_torch/csrc/phase_a_walk.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, bound with ctypes) on the current
stream, in place on the walk buffers ``wk`` (a ``packet._Walk`` on a CUDA
device). Its plain twin is ``tracer_torch.accel.packet._body``, which the
kernel equals bit for bit; CPU tensors run the twin
(``packet._iterate``), and for CUDA tensors ``walk`` launches the kernel
or raises. It replaces no Pallas kernel: phase A is XLA in the JAX package.

``KERNEL_LAUNCHES`` counts the launches and the counter
``packet.phase_a_kernel_iterations`` the iterations they run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch import obs
from tracer_torch._build import CSRC, nvcc_command, shared_library

TILE = 128  # rays per tile
SLOTS = 8  # children of a top-tree node

KERNEL_LAUNCHES = 0

SOURCE = CSRC / "phase_a_walk.cu"


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register use)."""
    path, log = shared_library("phase_a_walk", nvcc_command(), [SOURCE])
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.phase_a_walk_launch.restype = i32
    lib.phase_a_walk_launch.argtypes = [ptr] * 17 + [i32] * 5 + [ptr]
    return lib, log


def _check(wk) -> tuple[int, int, int, int]:
    """Raise ``ValueError`` on what the kernel does not take; returns
    (R, C, D, K)."""
    from tracer_torch.accel.packet import CHUNK_TILES

    st = wk.st
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    R, C, D, K = wk.top.shape[0], wk.o.shape[0], wk.D, wk.K
    want = {
        "top": (wk.top, f32, (R, SLOTS, 8)), "top_ref": (wk.top_ref, i64, (R, SLOTS)),
        "o": (wk.o, f32, (C, TILE, 3)), "inv_d": (wk.inv_d, f32, (C, TILE, 3)),
        "tmin": (wk.tmin, f32, (C, TILE)), "prune": (wk.prune, f32, (C, TILE)),
        "amax": (wk.amax, f32, (C,)),
        "cur": (st.cur, i64, (C,)), "level": (st.level, i64, (C,)), "asc": (st.asc, b8, (C,)),
        "done": (st.done, b8, (C,)), "paused": (st.paused, b8, (C,)),
        "snear": (st.snear, f32, (C, D, SLOTS)), "sref": (st.sref, i64, (C, D, SLOTS)),
        "eids": (wk.eids, i64, (C, K)), "enear": (wk.enear, f32, (C, K)),
        "en": (wk.en, i64, (C,)),
    }
    if not (1 <= C <= CHUNK_TILES) or D < 1 or K < SLOTS or R < 1:
        raise ValueError(f"phase_a_walk: C={C} (1..{CHUNK_TILES}), D={D} (>= 1), "
                         f"K={K} (>= {SLOTS}), R={R} (>= 1)")
    dev = wk.o.device
    for name, (x, dtype, shape) in want.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"phase_a_walk: {name} on {x.device}, rays on {dev} (CUDA only)")
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"phase_a_walk: {name} is {x.dtype} {tuple(x.shape)}"
                             f"{'' if x.is_contiguous() else ' (not contiguous)'}, "
                             f"wants {dtype} {shape} contiguous")
    if wk.top.data_ptr() % 16:
        raise ValueError("phase_a_walk: top must be 16-byte aligned")
    return R, C, D, K


def walk(wk, n: int) -> None:
    """``n`` iterations of the walk on every tile of ``wk``, in place: one
    launch on the current stream."""
    global KERNEL_LAUNCHES
    if n < 1:
        raise ValueError(f"phase_a_walk: n = {n}")
    R, C, D, K = _check(wk)
    st = wk.st
    lib, _ = build()
    ptrs = (wk.top, wk.top_ref, wk.o, wk.inv_d, wk.tmin, wk.prune, wk.amax, st.cur, st.level,
            st.asc, st.done, st.paused, st.snear, st.sref, wk.eids, wk.enear, wk.en)
    with torch.cuda.device(wk.o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.phase_a_walk_launch(*(x.data_ptr() for x in ptrs), R, C, D, K, n, stream)
    if err != 0:
        raise RuntimeError(f"phase_a_walk: kernel launch failed (cudaError {err})")
    KERNEL_LAUNCHES += 1
    obs.count("packet.phase_a_kernel_iterations", n)

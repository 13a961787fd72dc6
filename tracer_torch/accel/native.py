"""ctypes bindings for the repository's native C++ LBVH builder
(``native/lbvh.cpp``; port of the LBVH half of ``tracer.accel.native``).

The port compiles the shared source itself, with
``g++ -O3 -fopenmp -shared -fPIC``, into ``build/tracer_torch/`` — never
into ``native/``. Its output has the layout of ``lbvh.build`` and the same
primitive order and node count (held against it in the tests).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tracer_torch._build import REPO_ROOT, shared_library
from tracer_torch.accel.lbvh import BvhBuffers

_SRC = REPO_ROOT / "native" / "lbvh.cpp"
_N_STAGES = 5  # per-stage milliseconds the builder reports (not read here)


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = shared_library(
        "lbvh", ["g++", "-O3", "-fopenmp", "-shared", "-fPIC"], [_SRC]
    )
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.lbvh_build.restype = ctypes.c_int64
    lib.lbvh_build.argtypes = [
        f32p, f32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p, f64p,
    ]
    return lib


def build(prim_lo: np.ndarray, prim_hi: np.ndarray,
          max_prims: int = 4) -> BvhBuffers:
    """Native LBVH build; same output layout as ``lbvh.build``."""
    lib = _lib()
    n = prim_lo.shape[0]
    cap = max(2 * n, 1)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prim_ids = np.empty(n, np.int32)
    stage_ms = np.zeros(_N_STAGES, np.float64)
    m = lib.lbvh_build(
        lo, hi, n, max_prims, node_min, node_max, left, right, first,
        count, prim_ids, stage_ms,
    )
    if m < 0:
        raise RuntimeError("native LBVH build failed")
    m = int(m)
    return BvhBuffers(
        node_min=node_min[:m].copy(),
        node_max=node_max[:m].copy(),
        left=left[:m].copy(),
        right=right[:m].copy(),
        first=first[:m].copy(),
        count=count[:m].copy(),
        prim_ids=prim_ids,
    )

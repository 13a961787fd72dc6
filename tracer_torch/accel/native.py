"""ctypes bindings for the repository's native C++ builders (port of
``tracer.accel.native``): the LBVH (``native/lbvh.cpp``) and the BSP
(``native/bsp.cpp``).

The port compiles the shared sources itself into ``build/tracer_torch/``,
never into ``native/``: the LBVH with ``g++ -O3 -fopenmp -shared -fPIC``,
the BSP with the JAX package's ``-O3 -march=native -ffp-contract=off``
(no fused multiply-adds, so it rounds as the NumPy builder does). Their
outputs have the layouts of ``lbvh.build`` and ``bsp.build`` and are held
against them bit for bit in the tests. A failed compile or build raises;
nothing falls back to the NumPy builders.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tracer_torch._build import REPO_ROOT, shared_library
from tracer_torch.accel.lbvh import BvhBuffers

_SRC = REPO_ROOT / "native" / "lbvh.cpp"
_BSP_SRC = REPO_ROOT / "native" / "bsp.cpp"
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


@functools.cache
def _bsp_lib() -> ctypes.CDLL:
    path, _ = shared_library(
        "bsp", ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"],
        [_BSP_SRC])
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.bsp_build.restype = i64
    lib.bsp_build.argtypes = [f32p, f32p, i64, ctypes.c_int32, ctypes.c_int32]
    lib.bsp_counts.restype = None
    lib.bsp_counts.argtypes = [i64, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.bsp_copy.restype = None
    lib.bsp_copy.argtypes = [i64, i32p, f32p, i32p, i32p, i32p, i32p, i32p, f32p, f32p]
    lib.bsp_release.restype = None
    lib.bsp_release.argtypes = [i64]
    return lib


def bsp_build(prim_lo: np.ndarray, prim_hi: np.ndarray, max_depth: int,
              max_objects: int) -> dict:
    """Native BSP build; the arrays of ``bsp.BspBuffers`` by field name."""
    lib = _bsp_lib()
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    h = lib.bsp_build(lo, hi, lo.shape[0], max_depth, max_objects)
    if h < 0:
        raise RuntimeError("native BSP build failed")
    try:
        nodes, prims = ctypes.c_int64(), ctypes.c_int64()
        lib.bsp_counts(h, ctypes.byref(nodes), ctypes.byref(prims))
        m, p = int(nodes.value), int(prims.value)
        f = {k: np.empty(m, np.int32) for k in ("axis", "left", "right", "first", "count")}
        f["plane"] = np.empty(m, np.float32)
        prim_ids = np.empty(max(p, 1), np.int32)
        bbox_lo, bbox_hi = np.empty(3, np.float32), np.empty(3, np.float32)
        lib.bsp_copy(h, f["axis"], f["plane"], f["left"], f["right"], f["first"], f["count"],
                     prim_ids, bbox_lo, bbox_hi)
    finally:
        lib.bsp_release(h)
    return dict(axis=f["axis"], plane=f["plane"], left=f["left"], right=f["right"],
                first=f["first"], count=f["count"], prim_ids=prim_ids[:p],
                bbox_lo=bbox_lo, bbox_hi=bbox_hi)

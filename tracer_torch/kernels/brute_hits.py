"""The brute-force engine's closest-hit and any-hit queries as one CUDA
kernel each.

``closest(rays, vertices, indices)`` returns (t, triangle id) and
``any_hit(rays, vertices, indices)`` the blocked flags, each from one launch
of ``tracer_torch/csrc/brute_hits.cu`` (built with ``nvcc`` for ``sm_90a``
at first use, bound with ctypes) on the current stream, so a CUDA graph
captures it. The plain twins are
``tracer_torch.kernels.intersect.mesh_brute_force_reference`` and
``mesh_brute_force_anyhit_reference``, which the kernel equals bit for bit;
``intersect.mesh_brute_force`` and ``mesh_brute_force_anyhit`` run the
twins on CPU tensors and this kernel on CUDA tensors, with no fallback. It
replaces no Pallas kernel: the brute-force engine is XLA in the JAX package.

The rays' four tensors are read by their strides (``make_rays`` expands
tmin and tmax from one value with stride 0), so a query launches nothing
but the kernel. Indices must lie in [-V, V) for V vertices, as PyTorch's
indexing needs; the kernel does not check them (that would read the
device).

``KERNEL_LAUNCHES`` counts the launches and the counter
``brute.kernel_pairs`` the (ray, triangle) pairs they test.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch import obs
from tracer_torch._build import CSRC, nvcc_command, shared_library

KERNEL_LAUNCHES = 0

SOURCE = CSRC / "brute_hits.cu"
HEADERS = (CSRC / "moller.cuh",)


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register use)."""
    path, log = shared_library("brute_hits", nvcc_command(), [SOURCE], headers=HEADERS)
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.brute_hits_launch.restype = i32
    lib.brute_hits_launch.argtypes = ([i32] + [ptr, i64, i64] * 2 + [ptr, i64] * 2
                                      + [ptr, i64, i64] * 2 + [i32] * 3 + [ptr] * 4)
    return lib, log


def _check(rays, vertices, indices) -> tuple[int, int, int]:
    """Raise ``ValueError`` on what the kernel does not take; returns (rays,
    triangles, vertices). Dtypes and shapes are checked before the device,
    so the checks run on CPU tensors too."""
    f32 = torch.float32
    n = rays.o.shape[0] if rays.o.dim() == 2 else -1
    want = {
        "o": (rays.o, f32, (n, 3)), "d": (rays.d, f32, (n, 3)),
        "tmin": (rays.tmin, f32, (n,)), "tmax": (rays.tmax, f32, (n,)),
        "vertices": (vertices, f32, (*vertices.shape[:1], 3)),
        "indices": (indices, torch.int32, (*indices.shape[:1], 3)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"brute_hits: {name} is {x.dtype} {tuple(x.shape)}, "
                             f"wants {dtype} {shape}")
    T, V = indices.shape[0], vertices.shape[0]
    if max(n, T, V) >= 2 ** 31:
        raise ValueError(f"brute_hits: {n} rays, {T} triangles, {V} vertices (< 2**31 each)")
    dev = rays.o.device
    for name, (x, _, _) in want.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"brute_hits: {name} on {x.device}, rays on {dev} (CUDA only)")
    return n, T, V


def _launch(any_hit: bool, rays, vertices, indices) -> tuple:
    """Check, allocate the outputs, launch once (where there are rays) and
    count; returns (t, ids) or (blocked,)."""
    global KERNEL_LAUNCHES
    n, T, V = _check(rays, vertices, indices)
    dev = rays.o.device
    if any_hit:
        outs = (torch.empty(n, dtype=torch.bool, device=dev),)
        ptrs = (0, 0, outs[0].data_ptr())
    else:
        outs = (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))
        ptrs = (outs[0].data_ptr(), outs[1].data_ptr(), 0)
    if n:
        lib, _ = build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.brute_hits_launch(
                int(any_hit), rays.o.data_ptr(), *rays.o.stride(), rays.d.data_ptr(),
                *rays.d.stride(), rays.tmin.data_ptr(), rays.tmin.stride(0),
                rays.tmax.data_ptr(), rays.tmax.stride(0), vertices.data_ptr(),
                *vertices.stride(), indices.data_ptr(), *indices.stride(), n, T, V, *ptrs,
                stream)
        if err != 0:
            raise RuntimeError(f"brute_hits: kernel launch failed (cudaError {err})")
        KERNEL_LAUNCHES += 1
    obs.count("brute.kernel_pairs", n * T)
    return outs


def closest(rays, vertices, indices):
    """Closest hit over every triangle: (t, tri_id) as
    ``intersect.mesh_brute_force_reference`` gives them, in one launch."""
    return _launch(False, rays, vertices, indices)


def any_hit(rays, vertices, indices):
    """Whether some triangle is hit within each ray's window, as
    ``intersect.mesh_brute_force_anyhit_reference`` gives it, in one
    launch."""
    return _launch(True, rays, vertices, indices)[0]

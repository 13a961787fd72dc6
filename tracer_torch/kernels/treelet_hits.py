"""Ray-tile x treelet-block hits: the CUDA kernel and its plain-PyTorch twin.

Port of the Pallas TPU kernel ``tracer.kernels.treelet_hits.hits``, the hot
half of the packet engine (``tracer_torch.accel.packet``). Each tile of 128
rays streams the treelet blocks its top-tree walk emitted this round, in
emission order, while ``enear[k]`` (the block's entry distance) is below
the tile's largest best t; it tests every ray against every triangle of
each block and keeps the closest hit (or, in any-hit mode, the occlusion
flag).

* ``hits`` — the entry point. For CUDA tensors it launches the hand-written
  kernel ``tracer_torch/csrc/treelet_hits.cu`` (built with ``nvcc`` for
  ``sm_90a`` at first use, bound with ctypes) or raises; for CPU tensors it
  runs ``hits_reference``. It never falls back from CUDA to the twin.
* ``hits_reference`` — the same function in plain PyTorch: the JAX
  package's XLA phase B (``tracer.accel.packet._phase_b_xla``, one dense
  Möller test of the tile's rays against a block per emission slot) with
  the kernel's early break, through ``super_hits.moller_tile``, whose
  operation order is the kernel's; so on the card the two agree bit for
  bit.

A lane is live while ``tmin < bt``; one that is not can never hit again.
The kernel tests only live lanes and ends a tile's stream once none is
left; the twin skips the Möller test of a tile with no live lane. Both are
exact. ``hits_reference(stats=...)`` counts the tests the round needs
(``"live_tests"``) beside the visits.

A block is the treelet table's four contiguous quarter blocks
(``TreeletBvh.qblocks``), so no second copy of the table is kept.
``KERNEL_LAUNCHES`` counts kernel launches and ``REFERENCE_CALLS`` calls of
the twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch._build import CSRC, nvcc_command, shared_library
from tracer_torch.accel.treelet import NQ, ROWS
from tracer_torch.kernels.super_hits import INF, moller_tile

TILE = 128  # rays per tile (8x16 pixels)

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

SOURCE = CSRC / "treelet_hits.cu"
HEADERS = (CSRC / "moller.cuh",)

# Tiles tested together per Möller call in the twin: bounds its temporaries
# to CHUNK * TILE * T floats each (32 MB at T = 1024).
CHUNK = 64


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register and shared-memory use)."""
    path, log = shared_library("treelet_hits", nvcc_command(), [SOURCE], headers=HEADERS)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.treelet_hits_launch.restype = i32
    lib.treelet_hits_launch.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    return lib, log


def hits(tb, eids, en, o, d, tmin, best_t, best_pid, any_hit: bool, enear=None):
    """Consume one round of emissions; returns the updated (best_t, best_pid).

    tb: ``TreeletBvh``; eids: (n_tiles, K) block ids in emission order; en:
    (n_tiles,) counts; o, d: (n_tiles, 128, 3); tmin, best_t, best_pid:
    (n_tiles, 128). best_pid is carried as f32 (-1 = none); for any-hit it
    is the occlusion flag (> 0). ``enear``: (n_tiles, K) entry distances
    that enable the early break; None passes zeros, which break only once
    every lane's bound is <= 0.
    """
    if o.device.type == "cpu":
        return hits_reference(tb, eids, en, o, d, tmin, best_t, best_pid,
                              any_hit, enear)
    if o.device.type != "cuda":
        raise RuntimeError(f"treelet_hits: unsupported device {o.device}")
    global KERNEL_LAUNCHES
    n_tiles, K = eids.shape
    qblocks = tb.qblocks
    NTQ, rows, TQ = qblocks.shape
    if rows != ROWS or TQ % 4 != 0 or NTQ % NQ != 0 or qblocks.dtype != torch.float32:
        raise ValueError(f"treelet_hits: bad qblocks {tuple(qblocks.shape)} {qblocks.dtype}")
    if o.shape != (n_tiles, TILE, 3) or d.shape != o.shape:
        raise ValueError(f"treelet_hits: bad ray shape {tuple(o.shape)}")
    if en.shape != (n_tiles,) or (enear is not None and enear.shape != (n_tiles, K)):
        raise ValueError("treelet_hits: emission arrays disagree in shape")
    for name, x in (("qblocks", qblocks), ("eids", eids), ("en", en),
                    ("best_t", best_t), ("enear", enear)):
        if x is not None and x.device != o.device:
            raise ValueError(f"treelet_hits: {name} on {x.device}, rays on {o.device}")
    f32 = torch.float32
    rays8 = torch.stack(
        [o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2],
         tmin, best_t],
        dim=1,
    ).to(f32).contiguous()  # (n_tiles, 8, TILE)
    best = torch.stack([best_t, best_pid], dim=1).to(f32).contiguous()
    ids = eids.to(torch.int32).contiguous()
    en_ = en.to(torch.int32).contiguous()
    if enear is None:
        enear_ = torch.zeros((n_tiles, K), dtype=f32, device=o.device)
    else:
        enear_ = enear.to(f32).contiguous()
    qb = qblocks.contiguous()
    if qb.data_ptr() % 16:
        raise ValueError("treelet_hits: qblocks must be 16-byte aligned")
    out = torch.empty((n_tiles, 2, TILE), dtype=f32, device=o.device)
    lib, _ = build()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.treelet_hits_launch(
            ids.data_ptr(), en_.data_ptr(), enear_.data_ptr(), qb.data_ptr(),
            rays8.data_ptr(), best.data_ptr(), out.data_ptr(),
            n_tiles, K, NTQ // NQ, TQ, int(any_hit), stream,
        )
    if err != 0:
        raise RuntimeError(f"treelet_hits: kernel launch failed (cudaError {err})")
    KERNEL_LAUNCHES += 1
    return out[:, 0], out[:, 1]


def hits_reference(tb, eids, en, o, d, tmin, best_t, best_pid, any_hit: bool,
                   enear=None, stats: dict | None = None):
    """Plain-PyTorch twin of ``hits``: same arguments, same result.

    A loop over emission slots: at slot ``k`` every tile still in its
    stream (``k < en`` and ``enear[k]`` below its bound) tests its rays
    against block ``eids[:, k]``, then refreshes its bound. A tile with no
    live lane (``tmin < bt`` nowhere, with ``bt`` at -INF for an occluded
    any-hit lane) takes the block's "no hit" update without the test: no
    lane of it can hit. ``stats``, when given, receives the number of
    (tile, block) visits under ``"visits"``, the Möller tests the visits
    need, live lanes at the start of each visit x T, under ``"live_tests"``,
    and the visits of tiles with no live lane under ``"idle_visits"``.
    """
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    n_tiles, K = eids.shape
    NT = tb.NT
    T = tb.T
    dev = o.device
    blocks4 = tb.qblocks.reshape(NT, NQ, ROWS, T // NQ)
    bt = best_t.to(torch.float32).clone()
    bp = best_pid.to(torch.float32).clone()
    if any_hit:
        bt = torch.where(bp > 0.0, -INF, bt)
    rays = torch.cat([o, d, tmin[..., None]], dim=-1)  # (n_tiles, TILE, 7)
    ids = eids.long().clamp(0, NT - 1)
    if enear is None:
        enear = torch.zeros((n_tiles, K), dtype=torch.float32, device=dev)
    ub = torch.full((n_tiles,), INF, dtype=torch.float32, device=dev)
    tn = tmin.to(torch.float32)
    live = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    visits = live_tests = idle_visits = 0
    for k in range(K):
        live = live & (k < en) & (enear[:, k] < ub)
        lanes = (tn < bt).sum(dim=-1)  # live lanes of each tile
        tiles = torch.nonzero(live & (lanes > 0))[:, 0]
        idle = torch.nonzero(live & (lanes == 0))[:, 0]
        if tiles.numel() + idle.numel() == 0:
            break
        if stats is not None:
            visits += tiles.numel() + idle.numel()
            live_tests += int(lanes[tiles].sum()) * T
            idle_visits += idle.numel()
        if idle.numel():
            if not any_hit:  # the no-hit update: t = INF only lowers a bound above INF
                upper = bt[idle]
                bp[idle] = torch.where(INF < upper, -1.0, bp[idle])
                bt[idle] = torch.clamp_max(upper, INF)
            ub[idle] = bt[idle].amax(dim=-1)
        for a in range(0, tiles.numel(), CHUNK):
            ti = tiles[a:a + CHUNK]
            blk = blocks4[ids[ti, k]].permute(0, 2, 1, 3).reshape(-1, ROWS, T)
            upper = bt[ti]
            t, pid = moller_tile(blk, rays[ti], upper)
            if any_hit:
                hitk = t < INF
                bp[ti] = torch.where(hitk, 1.0, bp[ti])
                bt[ti] = torch.where(hitk, -INF, upper)
            else:
                better = t < upper
                bt[ti] = torch.where(better, t, upper)
                bp[ti] = torch.where(better, pid, bp[ti])
            ub[ti] = bt[ti].amax(dim=-1)
    if stats is not None:
        stats["visits"] = stats.get("visits", 0) + visits
        stats["live_tests"] = stats.get("live_tests", 0) + live_tests
        stats["idle_visits"] = stats.get("idle_visits", 0) + idle_visits
    out_t = best_t if any_hit else bt
    return out_t, bp

"""Super-tile streaming hits: the CUDA kernel and its plain-PyTorch twin.

Port of the Pallas TPU kernel ``tracer.kernels.super_hits.hits2``
(quarter-emission mode). One super-tile of 2048 rays (16 sub-tiles of 128)
walks its near-ordered list of quarter-block emissions: emissions with an
empty gate word are skipped, sub-tile ``s`` tests emission ``k`` only when
bit ``s`` is set and ``enear[k] < ub[s]`` (its largest current best t), and
the stream stops once ``enear[k]`` reaches every sub-tile's bound.

* ``hits2`` — the entry point. For CUDA tensors it launches the hand-written
  kernel ``tracer_torch/csrc/super_hits.cu`` (built with ``nvcc`` for
  ``sm_90a`` at first use, bound with ctypes; persistent clusters of 2
  CTAs, one super-tile at a time) or raises; for CPU tensors it runs
  ``hits2_reference``. It never falls back from CUDA to the twin.
* ``hits2_reference`` — the same function in plain PyTorch: a masked loop
  over emissions with the same gate and per-sub-tile skip rules and the
  same Möller operation order (``tracer/kernels/treelet_hits.py:57-68``),
  so on the card it agrees with the kernel bit for bit.

``KERNEL_LAUNCHES`` counts kernel launches and ``REFERENCE_CALLS`` calls of
the twin, so a run can show which one served it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch import obs
from tracer_torch._build import CSRC, nvcc_command, shared_library

SUB = 128  # rays per sub-tile (8x16 pixels)
NSUB = 16  # sub-tiles per super-tile
SUPER = SUB * NSUB  # rays per super-tile (32x64 pixels)
INF = 3.0e38  # the JAX package's _INF; any-hit lanes drop to -INF

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

SOURCE = CSRC / "super_hits.cu"
HEADERS = (CSRC / "moller.cuh",)


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register and shared-memory use)."""
    path, log = shared_library("super_hits", nvcc_command(), [SOURCE], headers=HEADERS)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.super_hits_launch.restype = i32
    lib.super_hits_launch.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    return lib, log


def hits2(tb, eids, enear, en, gatemask, o, d, tmin, best_t, best_pid,
          any_hit: bool):
    """Super-tile streaming hits over quarter-block emissions.

    tb: ``TreeletBvh`` (its ``qblocks`` table is streamed); eids/enear/
    gatemask: (n_super, KD) quarter ids, non-decreasing entry distances and
    16-bit gate words; en: (n_super,) emission counts; o, d: (n_super,
    SUPER, 3); tmin, best_t, best_pid: (n_super, SUPER). best_pid is carried
    as f32 (-1 = none); for any-hit it is the blocked flag (> 0).
    Returns the updated (best_t, best_pid).
    """
    if o.device.type == "cpu":
        return hits2_reference(tb, eids, enear, en, gatemask, o, d, tmin,
                               best_t, best_pid, any_hit)
    if o.device.type != "cuda":
        raise RuntimeError(f"super_hits: unsupported device {o.device}")
    global KERNEL_LAUNCHES
    n_super, KD = eids.shape
    qblocks = tb.qblocks
    NTQ, rows, TQ = qblocks.shape
    if rows != 16 or TQ % 4 != 0 or qblocks.dtype != torch.float32:
        raise ValueError(f"super_hits: bad qblocks {tuple(qblocks.shape)} {qblocks.dtype}")
    if o.shape != (n_super, SUPER, 3) or d.shape != o.shape:
        raise ValueError(f"super_hits: bad ray shape {tuple(o.shape)}")
    for name, x in (("qblocks", qblocks), ("eids", eids), ("enear", enear),
                    ("en", en), ("gatemask", gatemask), ("best_t", best_t)):
        if x.device != o.device:
            raise ValueError(f"super_hits: {name} on {x.device}, rays on {o.device}")
    if enear.shape != (n_super, KD) or gatemask.shape != (n_super, KD) \
            or en.shape != (n_super,):
        raise ValueError("super_hits: emission arrays disagree in shape")
    f32 = torch.float32
    rays8 = torch.stack(
        [o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2],
         tmin, best_t],
        dim=1,
    ).to(f32).contiguous()  # (n_super, 8, SUPER)
    best = torch.stack([best_t, best_pid], dim=1).to(f32).contiguous()
    ids = eids.to(torch.int32).contiguous()
    en_ = en.to(torch.int32).contiguous()
    enear_ = enear.to(f32).contiguous()
    gm = gatemask.to(torch.int32).contiguous()
    # The persistent clusters take super-tiles from a zeroed counter in the
    # order of their gated slots below en, most first (one device-side
    # sort, no host sync), so the longest streams start first; the result
    # does not depend on that order.
    slots = torch.arange(KD, dtype=torch.int32, device=o.device)
    work = ((gm != 0) & (slots < en_[:, None])).sum(dim=1)
    order = torch.argsort(work, descending=True, stable=True).to(torch.int32)
    ticket = torch.zeros(1, dtype=torch.int32, device=o.device)
    qb = qblocks.contiguous()
    if qb.data_ptr() % 16:
        raise ValueError("super_hits: qblocks must be 16-byte aligned")
    out = torch.empty((n_super, 2, SUPER), dtype=f32, device=o.device)
    lib, _ = build()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.super_hits_launch(
            ids.data_ptr(), en_.data_ptr(), enear_.data_ptr(), gm.data_ptr(),
            qb.data_ptr(), rays8.data_ptr(), best.data_ptr(), order.data_ptr(),
            ticket.data_ptr(), out.data_ptr(), n_super, KD, NTQ, TQ, int(any_hit),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"super_hits: kernel launch failed (cudaError {err})")
    KERNEL_LAUNCHES += 1
    return out[:, 0], out[:, 1]


def moller_tile(blk, rays, upper):
    """(M, 16, TQ) feature-major blocks vs (M, SUB, 7) rays [o, d, tmin]
    with (M, SUB) window tops -> per-ray (M, SUB) best (t, pid as f32).

    ``_moller_tile`` of the JAX package, operation for operation: min t
    wins, ties to the smallest prim id; pid -1 and t INF when nothing hits.
    """
    c = lambda j: blk[:, None, j, :]  # (M, 1, TQ)
    rx = lambda j: rays[:, :, j, None]  # (M, SUB, 1)
    ox, oy, oz = rx(0), rx(1), rx(2)
    dx, dy, dz = rx(3), rx(4), rx(5)
    tn = rx(6)
    nx, ny, nz = c(11), c(12), c(13)
    # In-place updates round exactly like the out-of-place expression they
    # stand for (one rounding per operation); they only save allocations.
    inv = nx * dx
    inv += ny * dy
    inv += nz * dz  # denom = nx*dx + ny*dy + nz*dz, (M, SUB, TQ)
    inv.reciprocal_()
    t = nx * ox
    t += ny * oy
    t += nz * oz
    t.neg_().add_(c(14)).mul_(inv)  # (k - (n.o)) * inv
    sx = c(0) - ox
    sy = c(1) - oy
    sz = c(2) - oz
    nomx = sy * dz
    nomx -= sz * dy
    nomy = sz * dx
    nomy -= sx * dz
    nomz = sx * dy
    nomz -= sy * dx
    beta = nomx * c(6)
    beta += nomy * c(7)
    beta += nomz * c(8)
    beta *= inv
    gamma = nomx * c(3)
    gamma += nomy * c(4)
    gamma += nomz * c(5)
    gamma.neg_().mul_(inv)
    ok = (beta >= 0.0) & (gamma >= 0.0)
    ok &= (beta + gamma) <= 1.0
    ok &= t >= tn
    ok &= t < upper[..., None]
    ok &= c(10) > 0.5
    tc = torch.where(ok, t, INF)
    tbest = tc.amin(dim=-1, keepdim=True)
    pidw = torch.where(tc <= tbest, c(9), INF)
    pbest = pidw.amin(dim=-1, keepdim=True)
    pbest = torch.where(tbest < INF, pbest, -1.0)
    return tbest[..., 0], pbest[..., 0]


# Sub-tiles tested together per Möller call in the twin: bounds its
# temporaries to ~CHUNK * SUB * TQ floats each.
CHUNK = 512


def hits2_reference(tb, eids, enear, en, gatemask, o, d, tmin, best_t,
                    best_pid, any_hit: bool, stats: dict | None = None):
    """Plain-PyTorch twin of ``hits2``: same arguments, same result.

    A loop over emission slots; at slot ``k`` every super-tile still in its
    stream tests, for each sub-tile whose gate bit is set and whose bound
    lies beyond ``enear[k]``, that sub-tile's rays against the block, then
    refreshes the sub-tile's bound and the super-tile's stream bound.
    ``stats``, when given, receives counts of the work (added to any it
    holds): ``"visits"``, the (sub-tile, quarter block) tests; ``"staged"``,
    the slots with a nonzero gate word that a stream reached; ``"rounds"``,
    those in which some sub-tile tests; ``"live_tests"``, the Möller tests
    of live lanes (tmin < best t before the block) in the visits; and per
    super-tile (n_super,) int64 tensors ``"super_rounds"`` and
    ``"super_visits"``.
    """
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    n_super, KD = eids.shape
    qblocks = tb.qblocks
    NTQ, _, TQ = qblocks.shape
    dev = o.device
    bt = best_t.to(torch.float32).reshape(n_super, NSUB, SUB).clone()
    bp = best_pid.to(torch.float32).reshape(n_super, NSUB, SUB).clone()
    if any_hit:
        bt = torch.where(bp > 0.0, -INF, bt)
    rays = torch.cat([o, d, tmin[..., None]], dim=-1).reshape(n_super, NSUB, SUB, 7)
    ids = eids.long().clamp(0, NTQ - 1)
    bits = torch.bitwise_left_shift(
        torch.ones(NSUB, dtype=torch.int64, device=dev),
        torch.arange(NSUB, dtype=torch.int64, device=dev),
    )
    gated = (gatemask.long()[:, :, None] & bits) != 0  # (n_super, KD, NSUB)
    ub = bt.amax(dim=-1)  # (n_super, NSUB) per-sub-tile bound
    gub = torch.full((n_super,), INF, dtype=torch.float32, device=dev)
    live = torch.ones(n_super, dtype=torch.bool, device=dev)
    counts = dict(visits=0, staged=0, rounds=0, live_tests=0)
    if stats is not None:
        sup_rounds = torch.zeros(n_super, dtype=torch.int64, device=dev)
        sup_visits = torch.zeros(n_super, dtype=torch.int64, device=dev)
    for k in range(KD):
        ek = enear[:, k]
        live = live & (k < en) & (ek < gub)
        if not bool(live.any()):
            break
        run = live[:, None] & gated[:, k] & (ek[:, None] < ub)
        sup_i, sub_i = torch.nonzero(run, as_tuple=True)
        counts["visits"] += sup_i.shape[0]
        if stats is not None:
            tested = run.any(dim=1)
            counts["staged"] += int((live & (gatemask[:, k] != 0)).sum())
            counts["rounds"] += int(tested.sum())
            sup_rounds += tested
            sup_visits += run.sum(dim=1)
        for a in range(0, sup_i.shape[0], CHUNK):
            si, s = sup_i[a:a + CHUNK], sub_i[a:a + CHUNK]
            upper = bt[si, s]
            if stats is not None:
                counts["live_tests"] += int((rays[si, s, :, 6] < upper).sum()) * TQ
            t, pid = moller_tile(qblocks[ids[si, k]], rays[si, s], upper)
            if any_hit:
                hitk = t < INF
                bp[si, s] = torch.where(hitk, 1.0, bp[si, s])
                bt[si, s] = torch.where(hitk, -INF, upper)
            else:
                better = t < upper
                bt[si, s] = torch.where(better, t, upper)
                bp[si, s] = torch.where(better, pid, bp[si, s])
            ub[si, s] = bt[si, s].amax(dim=-1)
        gub = ub.amax(dim=-1)
    if stats is not None:
        for key, n in counts.items():
            stats[key] = stats.get(key, 0) + n
        for key, n in (("super_rounds", sup_rounds), ("super_visits", sup_visits)):
            stats[key] = stats[key] + n if key in stats else n
    out_t = best_t if any_hit else bt.reshape(n_super, SUPER)
    return out_t, bp.reshape(n_super, SUPER)


def sweep(hits, tb, kd: int, overflow, o, d, tmin, best_t, best_pid,
          any_hit: bool, max_rounds: int):
    """The flat engine's overflow sweep (``tracer/accel/flat.py:573-606``):
    the super-tiles with ``overflow`` set test every quarter block in id
    order, ``kd`` per round, each round one call of ``hits`` with every
    gate bit on and the stream break off (entry distances 0). Rounds stop
    once every block is swept or at round ``max_rounds``. Returns the
    updated (best_t, best_pid) and the per-super-tile converged flag: not
    overflowing, or swept to the end before the cap."""
    with obs.span("super_hits.sweep"):
        n_super = o.shape[0]
        nd = tb.qblocks.shape[0]
        rounds = 1
        if obs.host_read("super_hits.overflow", overflow.any()):
            dev = o.device
            iota = torch.arange(kd, dtype=torch.int32, device=dev).expand(n_super, kd)
            zeros = torch.zeros((n_super, kd), dtype=torch.float32, device=dev)
            full_mask = torch.full((n_super, kd), (1 << NSUB) - 1,
                                   dtype=torch.int32, device=dev)
            while (rounds - 1) * kd < nd and rounds < max_rounds:
                base = (rounds - 1) * kd
                ids_r = torch.clamp_max(iota + base, nd - 1)
                en_r = torch.where(overflow, min(max(nd - base, 0), kd), 0)
                best_t, best_pid = hits(tb, ids_r, zeros, en_r.to(torch.int32), full_mask,
                                        o, d, tmin, best_t, best_pid, any_hit)
                rounds += 1
        return best_t, best_pid, ~overflow | ((rounds - 1) * kd >= nd)

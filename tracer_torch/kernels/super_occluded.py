"""Kernel B1's any-hit query, redesigned for the card: the CUDA kernel and
its twin route.

The flat engine's occlusion query (``tracer.accel.flat.any_hit`` in the JAX
package) runs the Pallas kernel ``tracer.kernels.super_hits.hits2`` in
any-hit mode over the culled list of quarter-block emissions, then, for the
super-tiles with more than K survivors, over every quarter block in id
order, one launch per round of KD blocks (``tracer/accel/flat.py:573-606``).
A lane's blocked flag is an OR over the blocks it is tested against, so
here the list and the sweep are one set of (sub-tile, quarter) tests.

* ``occluded`` — the entry point. For CUDA tensors it launches the
  hand-written kernel ``tracer_torch/csrc/super_occluded.cu`` (built with
  ``nvcc`` for ``sm_90a`` at first use, bound with ctypes; persistent CTAs
  over work items, see the source) or raises; for CPU tensors it runs
  ``occluded_reference``. It never falls back from CUDA to the twin.
* ``occluded_reference`` — the twin route, the JAX package's order of
  work: ``hits`` (default ``super_hits.hits2_reference``) over the culled
  list, then ``super_hits.sweep``'s id-order rounds.

Both return the input best t row unchanged, the blocked flags (the input
flags with 1.0 where a lane is newly blocked) and the per-super-tile
converged flag. ``KERNEL_LAUNCHES`` counts kernel launches and
``REFERENCE_CALLS`` calls of the twin route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch import obs
from tracer_torch._build import CSRC, nvcc_command, shared_library
from tracer_torch.kernels import super_hits
from tracer_torch.kernels.super_hits import NSUB, SUPER

KERNEL_LAUNCHES = 0
REFERENCE_CALLS = 0

SOURCE = CSRC / "super_occluded.cu"
HEADERS = (CSRC / "moller.cuh",)

# Emission slots or sweep quarters per work item: one per thread of a CTA
# when the item's candidates are gathered (the kernel's kChunk).
CHUNK = 64

# The sweep gate's margins (the kernel's kPad, kCondPad, kCosFloor and
# kCosSlack). The twin sweeps every quarter ungated, so the gate may close a
# (sub-tile, quarter) pair only where no lane can hit: each quarter box
# grows, on each axis k, by GATE_PAD * mag_k + COND_PAD * G * cond / c_lo.
# mag_k is the sum of the magnitudes of the box's and the origins' bounds on
# axis k; G = A + W + M / 8 sums over the axes the largest distance from an
# origin to the box (A), the box's extent (W) and the largest magnitudes of
# a box and an origin coordinate (M); cond is the quarter's largest
# |e0| |e1| / |n| and c_lo a lower bound on |n . d| / (|n| |d|) over the
# quarter's normal box and the sub-tile's direction box (COS_SLACK covers
# that bound's own rounding). Where c_lo is not above COS_FLOOR * cond or
# the second term reaches L (the sum of mag_k), the quarter's triangles are
# taken one by one: the second term becomes COND_PAD * G times the largest
# |e0| |e1| |d| / |n . d| over them, and the gate stays open only where some
# triangle's |n . d| may be 0 over the direction box, that ratio reaches
# 1 / COS_FLOOR or the term reaches L. The bound that these constants meet
# is written down in csrc/super_occluded.cu.
GATE_PAD = 2.0 ** -16
COND_PAD = 2.0 ** -19
COS_FLOOR = 2.0 ** -16
COS_SLACK = 2.0 ** -20
# (sub-tile, quarter) pairs per step of the plain version's triangle pass.
PAIR_CHUNK = 8192


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register and shared-memory use)."""
    path, log = shared_library("super_occluded", nvcc_command(), [SOURCE],
                               headers=HEADERS)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.super_occluded_launch.restype = i32
    lib.super_occluded_launch.argtypes = [ptr] * 14 + [i32] * 7 + [ptr]
    lib.super_occluded_gates_launch.restype = i32
    lib.super_occluded_gates_launch.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    return lib, log


def sweep_length(nd: int, kd: int, max_rounds: int) -> int:
    """Quarter blocks that the overflow sweep reaches, in id order, before
    the round cap: ``super_hits.sweep`` runs at most ``max_rounds - 1``
    rounds of ``kd``."""
    return min(nd, max(max_rounds - 1, 0) * kd)


def converged(tb, em, max_rounds: int) -> torch.Tensor:
    """(n_super,) the twin route's converged flag: not overflowing, or the
    sweep reached every quarter block before the cap."""
    nd = tb.qblocks.shape[0]
    return ~em.overflow | (sweep_length(nd, em.ids.shape[1], max_rounds) >= nd)


def _axes(x):
    """x[..., 0] + x[..., 1] + x[..., 2], in that order."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _cos_terms(n_lo, n_hi, d_lo, d_hi):
    """The interval dot product of [n_lo, n_hi] and [d_lo, d_hi] (..., 3):
    its lower bound on |n . d| less COS_SLACK times its terms'
    magnitudes."""
    from tracer_torch.accel.flat import _imul

    p_lo, p_hi = _imul(n_lo, n_hi, d_lo, d_hi)
    terms = torch.maximum(n_lo.abs(), n_hi.abs()) * torch.maximum(d_lo.abs(), d_hi.abs())
    return torch.maximum(_axes(p_lo), -_axes(p_hi)) - COS_SLACK * _axes(terms)


def _triangle_margins(tb, sb, dd, g, total, pick):
    """The second term and its open rule from the quarter's triangles one by
    one, for the pairs ``pick`` (sub-tile u, s and quarter q index tensors):
    (extra, useful) per pair, the triangle pass of the kernel's
    ``sweep_chunk_gates`` and what ``quarter_gate`` makes of it."""
    extra, useful = [], []
    for a in range(0, pick[0].numel(), PAIR_CHUNK):
        u, s, q = (x[a:a + PAIR_CHUNK] for x in pick)
        blk = tb.qblocks[q]  # (P, 16, TQ)
        rows = lambda j: blk[:, j:j + 3].transpose(1, 2)  # (P, TQ, 3)
        n, e0, e1 = rows(11), rows(3), rows(6)
        d_lo, d_hi = sb[u, s, None, 6:9], sb[u, s, None, 9:12]  # (P, 1, 3)
        ok = (blk[:, 10] > 0.5) & (n != 0.0).any(dim=-1)
        ell = _cos_terms(n, n, d_lo, d_hi)
        r2 = ((_axes(e0 * e0) * _axes(e1 * e1)) / (ell * ell)) * dd[a:a + PAIR_CHUNK, None]
        bad = (ok & ~(ell > 0.0)).any(dim=-1)
        r2 = torch.where(ok, r2, 0.0).amax(dim=-1)
        t = total[a:a + PAIR_CHUNK]
        e = COND_PAD * (g[a:a + PAIR_CHUNK] * torch.sqrt(r2))
        extra.append(e)
        useful.append(~bad & (r2 < COS_FLOOR ** -2) & (e < t))
    return torch.cat(extra), torch.cat(useful)


def sweep_gates(tb, em) -> torch.Tensor:
    """(n_super, NSUB, n_quarters) bool: the kernel's gate of each sub-tile
    against each quarter block in the sweep, operation for operation
    (``sweep_chunk_gates`` in the source): ``flat._sub_gates_raw``'s test
    on the quarter box grown by the margins above, or open where the second
    term is of no use. ``COND_PAD = 0`` turns the second term and the open rule
    off; with ``GATE_PAD = 0`` too the gates are ``_sub_gates_raw``'s
    exactly."""
    from tracer_torch.accel.flat import interval_slab

    box = tb.qbox.reshape(-1, 6)[None, None]  # (1, 1, nq, 6)
    qn = tb.qnorm.reshape(-1, 8)[None, None]  # (1, 1, nq, 8)
    sb = em.sb[:, :, None, :]  # (n_super, NSUB, 1, 16)
    o_lo, o_hi, d_lo, d_hi = sb[..., 0:3], sb[..., 3:6], sb[..., 6:9], sb[..., 9:12]
    lo, hi = box[..., 0:3], box[..., 3:6]
    cond = qn[..., 6]
    mag = (lo.abs() + hi.abs()) + (o_lo.abs() + o_hi.abs())
    far_o = torch.maximum(hi - o_lo, o_hi - lo)
    big = torch.maximum(lo.abs(), hi.abs()) + torch.maximum(o_lo.abs(), o_hi.abs())
    g = (_axes(far_o) + _axes(hi - lo)) + 0.125 * _axes(big)
    # c_lo: the normal box against the direction box, over the largest |d|.
    dd = _axes(torch.maximum(d_lo * d_lo, d_hi * d_hi))  # (n_super, NSUB, 1)
    c_lo = _cos_terms(qn[..., 0:3], qn[..., 3:6], d_lo, d_hi) / torch.sqrt(dd)
    total = _axes(mag)
    extra = (COND_PAD * (g * cond)) / c_lo
    useful = (c_lo > COS_FLOOR * cond) & (extra < total)
    has = (cond > 0.0) & (COND_PAD > 0.0) & (sb[..., 13] > 0.5)
    pick = (has & ~useful).nonzero(as_tuple=True)
    extra = torch.where(has & useful, extra, 0.0)
    opened = torch.zeros_like(useful)
    if pick[0].numel():
        e2, useful2 = _triangle_margins(tb, em.sb, dd[pick[0], pick[1], 0], g[pick],
                                        total[pick], pick)
        extra[pick] = torch.where(useful2, e2, 0.0)
        opened[pick] = ~useful2
    m = GATE_PAD * mag + extra[..., None]
    near, far = interval_slab(lo - m, hi + m, o_lo, o_hi, d_lo, d_hi)
    near = torch.clamp_min(near, 0.0)
    hit = (near <= far) & (far >= sb[..., 12]) & (near < em.prune_sub[:, :, None])
    return (hit | opened) & (sb[..., 13] > 0.5)


def _packed_bounds(em) -> torch.Tensor:
    """The kernel's sub-tile bounds: ``sub_bounds`` with the window top in
    column 14 (a pad there)."""
    return torch.cat([em.sb[..., :14], em.prune_sub[..., None], em.sb[..., 15:]],
                     dim=-1).to(torch.float32).contiguous()


def kernel_sweep_gates(tb, em) -> torch.Tensor:
    """(n_super, NSUB, n_quarters) bool: the sweep gates as the kernel's
    own code computes them (``sweep_chunk_gates``, one CTA per sub-tile and
    chunk of quarters), for CUDA tensors; for holding them to
    ``sweep_gates`` on the card. Not on the query's path:
    ``KERNEL_LAUNCHES`` does not count it."""
    if em.sb.device.type != "cuda":
        raise RuntimeError(f"super_occluded: kernel_sweep_gates takes CUDA tensors, "
                           f"not {em.sb.device}")
    n_sub, ntq = em.n_super * NSUB, tb.qbox.reshape(-1, 6).shape[0]
    sbp = _packed_bounds(em)
    qbox, qnorm, qb = tb.qbox.contiguous(), tb.qnorm.contiguous(), tb.qblocks.contiguous()
    out = torch.empty((n_sub, ntq), dtype=torch.uint8, device=em.sb.device)
    lib, _ = build()
    with torch.cuda.device(em.sb.device):
        err = lib.super_occluded_gates_launch(
            sbp.data_ptr(), qbox.data_ptr(), qnorm.data_ptr(), qb.data_ptr(), out.data_ptr(),
            n_sub, ntq, qb.shape[2], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"super_occluded: gates launch failed (cudaError {err})")
    return out.reshape(em.n_super, NSUB, ntq).bool()


def open_share(tb, em, gates, max_rounds: int) -> tuple[int, int]:
    """(open, total): the sweep's (sub-tile, quarter) pairs that ``gates``
    leaves open, over those the sweep reaches (live sub-tiles of
    overflowing super-tiles, quarters below ``sweep_length``)."""
    n_sweep = sweep_length(tb.qblocks.shape[0], em.ids.shape[1], max_rounds)
    swept = em.overflow[:, None] & (em.sb[:, :, 13] > 0.5)
    return int((gates[..., :n_sweep] & swept[..., None]).sum()), int(swept.sum()) * n_sweep


def work_items(em, n_sweep: int):
    """The kernel's work items, each (super-tile, sub-tile, chunk): chunks
    0 .. NCL-1 hold CHUNK slots of the culled list, chunks NCL .. NCH-1
    CHUNK quarters of the sweep. Returns (order, key, NCL, NCH): the item
    ids (super * NSUB + sub) * NCH + chunk sorted by ``key``, largest
    first, and the sorted keys, 0 for items with nothing to do. A sweep
    chunk's key is CHUNK plus its quarter count (for overflowing
    super-tiles with a live sub-tile), a list chunk's its gated slots below
    ``en``: the sweeps, spread over many short items, start first, and the
    list items that follow find most of their lanes blocked already (on
    the shadowed dragon this ran 18% fewer live tests than the list
    first, PERF.md §6)."""
    n_super, kd = em.ids.shape
    dev = em.ids.device
    ncl = -(-kd // CHUNK)
    ncs = -(-n_sweep // CHUNK)
    bits = torch.arange(NSUB, dtype=torch.int32, device=dev)
    slots = torch.arange(ncl * CHUNK, dtype=torch.int32, device=dev)
    gm = torch.nn.functional.pad(em.gm.to(torch.int32), (0, ncl * CHUNK - kd))
    gated = ((gm[:, :, None] >> bits) & 1) * (slots < em.en[:, None])[:, :, None]
    list_key = gated.reshape(n_super, ncl, CHUNK, NSUB).sum(dim=2).transpose(1, 2)
    alive = em.sb[:, :, 13] > 0.5
    lens = (n_sweep - torch.arange(ncs, device=dev) * CHUNK).clamp(max=CHUNK)
    sweep_key = (em.overflow[:, None] & alive)[:, :, None] * (lens + CHUNK)
    key = torch.cat([list_key, sweep_key], dim=2).reshape(-1).to(torch.int32)
    key, order = torch.sort(key, descending=True, stable=True)
    return order.to(torch.int32), key, ncl, ncl + ncs


def occluded(tb, em, max_rounds: int, counts: torch.Tensor | None = None):
    """The any-hit query of one wavefront's emissions ``em``
    (``flat.emissions(..., any_hit=True)``): (best t, blocked flags,
    converged), all as ``occluded_reference``'s. ``counts``, an optional
    (3,) int64 tensor on the card, receives the kernel's own work (added):
    work items run, (sub-tile, quarter) tests, Möller tests of live lanes."""
    with obs.span("super_occluded.occluded"):
        if em.o.device.type == "cpu":
            return occluded_reference(tb, em, max_rounds)
        if em.o.device.type != "cuda":
            raise RuntimeError(f"super_occluded: unsupported device {em.o.device}")
        global KERNEL_LAUNCHES
        n_super, kd = em.ids.shape
        qblocks = tb.qblocks
        ntq, rows, tq = qblocks.shape
        if rows != 16 or tq % 4 != 0 or qblocks.dtype != torch.float32:
            raise ValueError(f"super_occluded: bad qblocks {tuple(qblocks.shape)} {qblocks.dtype}")
        if tb.qbox.numel() != ntq * 6 or tb.qbox.dtype != torch.float32:
            raise ValueError(f"super_occluded: bad qbox {tuple(tb.qbox.shape)}")
        if tb.qnorm.numel() != ntq * 8 or tb.qnorm.dtype != torch.float32:
            raise ValueError(f"super_occluded: bad qnorm {tuple(tb.qnorm.shape)}")
        if em.o.shape != (n_super, SUPER, 3) or em.sb.shape != (n_super, NSUB, 16):
            raise ValueError(f"super_occluded: bad ray shape {tuple(em.o.shape)}")
        for name, x in (("qblocks", qblocks), ("qbox", tb.qbox), ("qnorm", tb.qnorm),
                        ("ids", em.ids), ("gm", em.gm), ("bp0", em.bp0)):
            if x.device != em.o.device:
                raise ValueError(f"super_occluded: {name} on {x.device}, rays on {em.o.device}")
        if counts is not None and (counts.dtype != torch.int64 or counts.shape != (3,)
                                   or counts.device != em.o.device):
            raise ValueError("super_occluded: counts must be a (3,) int64 tensor on the card")
        f32, i32 = torch.float32, torch.int32
        n_sweep = sweep_length(ntq, kd, max_rounds)
        rays = torch.cat([em.o, em.d, em.tmin[..., None], em.bt0[..., None]],
                         dim=-1).to(f32).contiguous()  # (n_super, SUPER, 8)
        sbp = _packed_bounds(em)
        flags = em.bp0.to(f32).clone().contiguous()  # the kernel sets 1.0 in place
        ids = em.ids.to(i32).contiguous()
        en = em.en.to(i32).contiguous()
        enear = em.enear.to(f32).contiguous()
        gm = em.gm.to(i32).contiguous()
        qb = qblocks.contiguous()
        qbox = tb.qbox.contiguous()
        qnorm = tb.qnorm.contiguous()
        if qb.data_ptr() % 16:
            raise ValueError("super_occluded: qblocks must be 16-byte aligned")
        order, key, ncl, nch = work_items(em, n_sweep)
        ticket = torch.zeros(1, dtype=i32, device=em.o.device)
        lib, _ = build()
        with torch.cuda.device(em.o.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.super_occluded_launch(
                ids.data_ptr(), en.data_ptr(), enear.data_ptr(), gm.data_ptr(),
                qb.data_ptr(), qbox.data_ptr(), qnorm.data_ptr(), sbp.data_ptr(),
                rays.data_ptr(),
                order.data_ptr(), key.data_ptr(), ticket.data_ptr(), flags.data_ptr(),
                counts.data_ptr() if counts is not None else None,
                order.shape[0], kd, ntq, tq, ncl, nch, n_sweep, stream,
            )
        if err != 0:
            raise RuntimeError(f"super_occluded: kernel launch failed (cudaError {err})")
        KERNEL_LAUNCHES += 1
        return em.bt0, flags, converged(tb, em, max_rounds)


def occluded_reference(tb, em, max_rounds: int, hits=None, stats: dict | None = None):
    """The twin route of ``occluded``: ``hits`` (default
    ``super_hits.hits2_reference``; ``super_hits.hits2`` gives the launches
    the JAX package's order of work makes on the card) in any-hit mode over
    the culled list, then ``super_hits.sweep``'s id-order rounds (every gate
    bit on, entry distances 0) for the overflowing super-tiles, at most
    ``max_rounds - 1`` of them. ``stats`` is passed to every
    ``hits2_reference`` call (counts add up over the list and the rounds).
    Returns (best t, blocked flags, converged)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    hits = hits if hits is not None else super_hits.hits2_reference
    if stats is not None:
        hits = functools.partial(hits, stats=stats)
    args = (em.o, em.d, em.tmin)
    bt, bp = hits(tb, em.ids, em.enear, em.en, em.gm, *args, em.bt0, em.bp0, True)
    return super_hits.sweep(hits, tb, em.ids.shape[1], em.overflow, *args, bt, bp,
                            True, max_rounds)

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

# The sweep gate's margin (the kernel's kPad): each quarter box grows, on
# each axis, by GATE_PAD times the magnitudes of its bounds and of the
# sub-tile's origin bounds, so that rounding in the interval test or in the
# Möller test cannot close a gate on a quarter that a lane hits.
GATE_PAD = 2.0 ** -16


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile (first call only) and load the kernel library; returns the
    library and the compiler's output (register and shared-memory use)."""
    path, log = shared_library("super_occluded", nvcc_command(), [SOURCE],
                               headers=HEADERS)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.super_occluded_launch.restype = i32
    lib.super_occluded_launch.argtypes = [ptr] * 13 + [i32] * 7 + [ptr]
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


def sweep_gates(tb, em) -> torch.Tensor:
    """(n_super, NSUB, n_quarters) bool: the kernel's gate of each sub-tile
    against each quarter block in the sweep, operation for operation:
    ``flat._sub_gates_raw``'s test on the quarter box grown by
    ``GATE_PAD`` times the sum of the magnitudes of its bounds and of the
    sub-tile's origin bounds, axis by axis (with ``GATE_PAD = 0``,
    ``_sub_gates_raw``'s gates exactly)."""
    from tracer_torch.accel.flat import interval_slab

    box = tb.qbox.reshape(-1, 6)[None, None]  # (1, 1, nq, 6)
    sb = em.sb[:, :, None, :]  # (n_super, NSUB, 1, 16)
    o_lo, o_hi = sb[..., 0:3], sb[..., 3:6]
    lo, hi = box[..., 0:3], box[..., 3:6]
    m = GATE_PAD * ((lo.abs() + hi.abs()) + (o_lo.abs() + o_hi.abs()))
    near, far = interval_slab(lo - m, hi + m, o_lo, o_hi, sb[..., 6:9], sb[..., 9:12])
    near = torch.clamp_min(near, 0.0)
    return ((near <= far) & (far >= sb[..., 12]) & (near < em.prune_sub[:, :, None])
            & (sb[..., 13] > 0.5))


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
    if em.o.shape != (n_super, SUPER, 3) or em.sb.shape != (n_super, NSUB, 16):
        raise ValueError(f"super_occluded: bad ray shape {tuple(em.o.shape)}")
    for name, x in (("qblocks", qblocks), ("qbox", tb.qbox), ("ids", em.ids),
                    ("gm", em.gm), ("bp0", em.bp0)):
        if x.device != em.o.device:
            raise ValueError(f"super_occluded: {name} on {x.device}, rays on {em.o.device}")
    if counts is not None and (counts.dtype != torch.int64 or counts.shape != (3,)
                               or counts.device != em.o.device):
        raise ValueError("super_occluded: counts must be a (3,) int64 tensor on the card")
    f32, i32 = torch.float32, torch.int32
    n_sweep = sweep_length(ntq, kd, max_rounds)
    rays = torch.cat([em.o, em.d, em.tmin[..., None], em.bt0[..., None]],
                     dim=-1).to(f32).contiguous()  # (n_super, SUPER, 8)
    # Sub-tile bounds with the window top in column 14 (a pad of sub_bounds).
    sbp = torch.cat([em.sb[..., :14], em.prune_sub[..., None], em.sb[..., 15:]],
                    dim=-1).to(f32).contiguous()
    flags = em.bp0.to(f32).clone().contiguous()  # the kernel sets 1.0 in place
    ids = em.ids.to(i32).contiguous()
    en = em.en.to(i32).contiguous()
    enear = em.enear.to(f32).contiguous()
    gm = em.gm.to(i32).contiguous()
    qb = qblocks.contiguous()
    qbox = tb.qbox.contiguous()
    if qb.data_ptr() % 16:
        raise ValueError("super_occluded: qblocks must be 16-byte aligned")
    order, key, ncl, nch = work_items(em, n_sweep)
    ticket = torch.zeros(1, dtype=i32, device=em.o.device)
    lib, _ = build()
    with torch.cuda.device(em.o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.super_occluded_launch(
            ids.data_ptr(), en.data_ptr(), enear.data_ptr(), gm.data_ptr(),
            qb.data_ptr(), qbox.data_ptr(), sbp.data_ptr(), rays.data_ptr(),
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

"""Flat frustum traversal: dense super-tile culling + per-sub-tile hits
(port of ``tracer.accel.flat``, quarter-block emission).

* The frame is cut into 32x64-pixel super-tiles (2048 rays = 16 sub-tiles
  of 8x16). Each super-tile is summarized by an interval bound (origin
  AABB, per-axis direction interval, t window).
* One dense (n_super, NT) conservative interval slab test culls every
  treelet against every super-tile; the survivors are ordered near-first
  and cut to K emissions. Each emission is refined to its NQ quarter
  blocks, with one 16-bit gate word per quarter (bit s: sub-tile s's
  frustum meets the quarter's box).
* The closest-hit query feeds the emissions to the super-tile hits
  kernel (``tracer_torch.kernels.super_hits.hits2``), which is per-ray
  exact. Super-tiles with more than K survivors sweep the remaining blocks
  in id order (``super_hits.sweep``), and a lane whose sweep hits the round
  cap is reported as not converged. With a temporal seed (last frame's hit
  distance), lanes whose seeded window found nothing are re-traced with
  their full window, so the result equals the unseeded one.
* The any-hit query hands the emissions to
  ``tracer_torch.kernels.super_occluded.occluded``: the culled list and the
  overflow sweep in one launch, with the same blocked and converged flags.

Host control flow replaces the JAX package's ``lax.cond``/``while_loop``:
the repair pass runs only when a lane needs it, and the closest-hit
overflow sweep is a loop of rounds on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tracer_torch import obs
from tracer_torch.accel.treelet import NQ, TreeletBvh
from tracer_torch.kernels import super_hits, super_occluded
from tracer_torch.kernels.intersect import Rays
from tracer_torch.kernels.super_hits import NSUB, SUB, SUPER

_INF = 3.0e38
_BIG = 1.0e18  # indefinite-interval sentinel (safe in products)
# Emission budget per super-tile: a frame super-tile of the dragon stand-in
# keeps well under this many treelets after the cull; larger working sets
# stay exact through the id-ordered overflow sweep.
K_EMIT = 96
MAX_ROUNDS = 4096

# Super-tile pixel geometry: 4x4 grid of 8x16 sub-tiles.
SUP_H, SUP_W = 32, 64
SUB_H, SUB_W = 8, 16

# Temporal seed slack: the previous frame's hit distance bounds this
# frame's; lanes whose true hit lands beyond the slack are repaired.
SEED_REL = 1.01
SEED_ABS = 1.0e-3


def _pads(W: int, H: int):
    Hp = -(-H // SUP_H) * SUP_H
    Wp = -(-W // SUP_W) * SUP_W
    return Hp, Wp


def to_supers(x: torch.Tensor, W: int, H: int, fill):
    """(H*W, ...) row-major -> (n_super, SUPER, ...); sub-tile-major inside
    each super-tile."""
    Hp, Wp = _pads(W, H)
    rest = tuple(x.shape[1:])
    img = torch.full((Hp, Wp, *rest), fill, dtype=x.dtype, device=x.device)
    img[:H, :W] = x.reshape(H, W, *rest)
    img = img.reshape(Hp // SUP_H, 4, SUB_H, Wp // SUP_W, 4, SUB_W, *rest)
    perm = (0, 3, 1, 4, 2, 5) + tuple(range(6, 6 + len(rest)))
    return img.permute(perm).reshape(-1, SUPER, *rest)


def from_supers(x: torch.Tensor, W: int, H: int):
    Hp, Wp = _pads(W, H)
    rest = tuple(x.shape[2:])
    img = x.reshape(Hp // SUP_H, Wp // SUP_W, 4, 4, SUB_H, SUB_W, *rest)
    perm = (0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(rest)))
    img = img.permute(perm).reshape(Hp, Wp, *rest)
    return img[:H, :W].reshape(H * W, *rest)


def _linear_supers(x: torch.Tensor, fill):
    """Non-frame wavefronts: consecutive-lane sub-tiles."""
    n = x.shape[0]
    pad = (-n) % SUPER
    if pad:
        x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill,
                                     dtype=x.dtype, device=x.device)])
    return x.reshape(-1, SUPER, *x.shape[1:])


def _interval_fields(o, d, tmin, prune):
    """Interval summary over the last ray axis. o, d: (..., L, 3);
    tmin, prune: (..., L)."""
    alive = prune > tmin
    a3 = alive[..., None]
    o_lo = torch.where(a3, o, _BIG).amin(dim=-2)
    o_hi = torch.where(a3, o, -_BIG).amax(dim=-2)
    d_lo = torch.where(a3, d, _BIG).amin(dim=-2)
    d_hi = torch.where(a3, d, -_BIG).amax(dim=-2)
    tmin_lo = torch.where(alive, tmin, _BIG).amin(dim=-1)
    prune_hi = torch.where(alive, prune, -_BIG).amax(dim=-1)
    any_alive = alive.any(dim=-1)
    return o_lo, o_hi, d_lo, d_hi, tmin_lo, prune_hi, any_alive


def _imul(x_lo, x_hi, y_lo, y_hi):
    p1 = x_lo * y_lo
    p2 = x_lo * y_hi
    p3 = x_hi * y_lo
    p4 = x_hi * y_hi
    return (
        torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
        torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)),
    )


def interval_slab(lo, hi, o_lo, o_hi, d_lo, d_hi):
    """Conservative [near_lb, far_ub] of a ray-set interval bound vs slabs.

    All args (..., 3), broadcastable. Sign-spanning direction intervals keep
    an entry bound: rays whose d_k crosses 0 still need t >= gap / max|d_k|
    to reach a slab the origin box is outside of.
    """
    a_lo = lo - o_hi
    a_hi = lo - o_lo
    b_lo = hi - o_hi
    b_hi = hi - o_lo
    definite = (d_lo > 0.0) | (d_hi < 0.0)
    # Definite sign: 1/d is a proper interval (same sign, no pole).
    safe_lo = torch.where(definite, d_lo, 1.0)
    safe_hi = torch.where(definite, d_hi, 1.0)
    inv_lo = torch.reciprocal(safe_hi)
    inv_hi = torch.reciprocal(safe_lo)
    t0_lo, t0_hi = _imul(a_lo, a_hi, inv_lo, inv_hi)
    t1_lo, t1_hi = _imul(b_lo, b_hi, inv_lo, inv_hi)
    near_def = torch.minimum(t0_lo, t1_lo)
    far_def = torch.maximum(t0_hi, t1_hi)
    # Sign-spanning: no exit bound, but a valid entry bound if the origin
    # box sits outside the slab (gap > 0).
    gap = torch.clamp_min(torch.maximum(a_lo, -b_hi), 0.0)
    amax = torch.clamp_min(torch.maximum(-d_lo, d_hi), 1e-30)
    near_ind = gap / amax
    near = torch.where(definite, near_def, near_ind).amax(dim=-1)
    far = torch.where(definite, far_def, _BIG).amin(dim=-1)
    return near, far


def sub_bounds(o, d, tmin, prune):
    """Per-sub-tile packed bounds (n_super, NSUB, 16).
    Rows: [o_lo3, o_hi3, d_lo3, d_hi3, tmin_lo, alive, pad2]."""
    n_super = o.shape[0]
    o_lo, o_hi, d_lo, d_hi, tmin_lo, _, any_alive = _interval_fields(
        o.reshape(n_super, NSUB, SUB, 3), d.reshape(n_super, NSUB, SUB, 3),
        tmin.reshape(n_super, NSUB, SUB), prune.reshape(n_super, NSUB, SUB),
    )
    return torch.cat(
        [
            o_lo, o_hi, d_lo, d_hi,
            tmin_lo[..., None],
            any_alive[..., None].to(torch.float32),
            torch.zeros((n_super, NSUB, 2), dtype=torch.float32, device=o.device),
        ],
        dim=-1,
    )


def _frustum_cull(tb: TreeletBvh, bounds):
    """(n_super, NT) conservative hit mask + near lower bound."""
    o_lo, o_hi, d_lo, d_hi, tmin_lo, prune_hi, any_alive = bounds
    near, far = interval_slab(
        tb.t_lo[None, :, :], tb.t_hi[None, :, :],
        o_lo[:, None, :], o_hi[:, None, :],
        d_lo[:, None, :], d_hi[:, None, :],
    )
    ok = (
        (near <= far)
        & (far >= tmin_lo[:, None])
        & (near < prune_hi[:, None])
        & any_alive[:, None]
    )
    return ok, torch.where(ok, torch.clamp_min(near, 0.0), _INF)


def _sub_gates_raw(tb: TreeletBvh, ids, sb, prune_sub):
    """Per-(emission, sub-tile, quarter-block) conservative frustum tests.

    ids: (ns, K) treelet ids; sb: (ns, NSUB, 16) packed sub bounds;
    prune_sub: (ns, NSUB) initial per-sub window top.
    -> ok (ns, K, NSUB, NQ) bool, near (ns, K, NSUB, NQ) f32 (>= 0).
    """
    qb = tb.qbox[ids.clamp(0, tb.qbox.shape[0] - 1)]  # (ns, K, NQ, 6)
    lo = qb[:, :, None, :, 0:3]  # (ns, K, 1, NQ, 3)
    hi = qb[:, :, None, :, 3:6]
    o_lo = sb[:, None, :, None, 0:3]  # (ns, 1, NSUB, 1, 3)
    o_hi = sb[:, None, :, None, 3:6]
    d_lo = sb[:, None, :, None, 6:9]
    d_hi = sb[:, None, :, None, 9:12]
    near, far = interval_slab(lo, hi, o_lo, o_hi, d_lo, d_hi)
    tmin_lo = sb[:, None, :, None, 12]
    alive = sb[:, None, :, None, 13] > 0.5
    near = torch.clamp_min(near, 0.0)
    ok = (
        (near <= far)
        & (far >= tmin_lo)
        & (near < prune_sub[:, None, :, None])
        & alive
    )
    return ok, near


def _gate_words(ok):
    """(ns, K, NSUB, NQ) bool -> (ns, K*NQ) i32, bit s = sub-tile s."""
    powers = torch.arange(NSUB, dtype=torch.int32, device=ok.device)
    words = (ok.to(torch.int32) << powers[None, None, :, None]).sum(dim=2)
    return words.to(torch.int32).reshape(ok.shape[0], -1)


@dataclass(frozen=True)
class Emissions:
    """One wavefront tiled into super-tiles with its quarter emissions:
    exactly the inputs of the hits kernel, plus what the repair and
    overflow passes need."""

    o: torch.Tensor  # (ns, SUPER, 3)
    d: torch.Tensor  # (ns, SUPER, 3)
    tmin: torch.Tensor  # (ns, SUPER)
    tmax: torch.Tensor  # (ns, SUPER)
    ids: torch.Tensor  # (ns, KD) quarter ids, near-ordered
    enear: torch.Tensor  # (ns, KD) block entry distance per quarter
    en: torch.Tensor  # (ns,) emission count
    gm: torch.Tensor  # (ns, KD) i32 gate words
    bt0: torch.Tensor  # (ns, SUPER) initial window tops (seeded or tmax)
    bp0: torch.Tensor  # (ns, SUPER) initial pids (-1)
    seeded: torch.Tensor | None  # (ns, SUPER) lanes whose window was seeded
    overflow: torch.Tensor  # (ns,) more survivors than K
    sb: torch.Tensor  # (ns, NSUB, 16) packed sub-tile bounds (``sub_bounds``)
    prune_sub: torch.Tensor  # (ns, NSUB) initial per-sub-tile window tops
    untile: Callable

    @property
    def n_super(self) -> int:
        return int(self.o.shape[0])


def emissions(rays: Rays, tb: TreeletBvh, frame=None, any_hit: bool = False,
              K: int = K_EMIT, seed_t=None) -> Emissions:
    """Cull, order and gate the treelets for one wavefront."""
    with obs.span("flat.emissions"):
        n = rays.o.shape[0]
        if frame is not None and frame[0] * frame[1] == n:
            W, H = frame
            tile = lambda x, fill: to_supers(x, W, H, fill)
            untile = lambda x: from_supers(x, W, H)
        else:
            tile = _linear_supers
            untile = lambda x: x.reshape(-1)[:n]

        o = tile(rays.o, 1.0e30)
        d = tile(rays.d, 1.0)
        tmin = tile(rays.tmin, 1.0)
        tmax = tile(rays.tmax, 0.0)
        n_super = o.shape[0]
        NT = tb.NT
        K = min(K, NT)
        dev = o.device

        sb = sub_bounds(o, d, tmin, tmax)
        # Super-tile bound = union of its sub-tiles.
        alive_sub = sb[:, :, 13] > 0.5
        live = tmax.reshape(n_super, -1) > tmin.reshape(n_super, -1)
        super_bounds = (
            sb[:, :, 0:3].amin(dim=1),
            sb[:, :, 3:6].amax(dim=1),
            sb[:, :, 6:9].amin(dim=1),
            sb[:, :, 9:12].amax(dim=1),
            torch.where(alive_sub, sb[:, :, 12], _BIG).amin(dim=1),
            torch.where(live, tmax.reshape(n_super, -1), -_BIG).amax(dim=1),
            alive_sub.any(dim=1),
        )
        ok, near = _frustum_cull(tb, super_bounds)
        total = ok.sum(dim=1)
        # Near-first order, ties to the lower treelet id (a stable sort; the
        # tie order decides which of two equally near blocks is tested first).
        key = torch.where(ok, -near, -_INF)
        negnear, ids = torch.sort(key, dim=1, descending=True, stable=True)
        ids = ids[:, :K]
        enear = -negnear[:, :K]  # ascending conservative entry distance; INF pad

        prune_sub = torch.where(
            tmax.reshape(n_super, NSUB, SUB) > tmin.reshape(n_super, NSUB, SUB),
            tmax.reshape(n_super, NSUB, SUB), -_BIG,
        ).amax(dim=2)
        # Temporal t-bound seeding (closest-hit only): each lane's initial best
        # t is last frame's hit distance plus slack. Gates and emissions keep
        # the original windows, so the same list serves the repair pass.
        seeded = None
        if seed_t is not None and not any_hit:
            st = tile(seed_t, 0.0)
            bound = st * SEED_REL + SEED_ABS
            seeded = (st > 0.0) & (bound < tmax)
            bt0 = torch.where(seeded, bound, tmax)
        else:
            bt0 = tmax
        bp0 = torch.full((n_super, SUPER), -1.0, dtype=torch.float32, device=dev)

        ok_q, _ = _sub_gates_raw(tb, ids, sb, prune_sub)
        gm = _gate_words(ok_q)  # (ns, K*NQ)
        qids = (ids[:, :, None] * NQ
                + torch.arange(NQ, dtype=ids.dtype, device=dev)).reshape(n_super, K * NQ)
        # Stream break key: the BLOCK near, replicated per quarter — the stream
        # is monotone in it.
        enear = torch.repeat_interleave(enear, NQ, dim=1)
        en = torch.clamp_max(total, K) * NQ
        return Emissions(
            o=o, d=d, tmin=tmin, tmax=tmax, ids=qids.to(torch.int32),
            enear=enear, en=en.to(torch.int32), gm=gm, bt0=bt0, bp0=bp0,
            seeded=seeded, overflow=total > K, sb=sb, prune_sub=prune_sub,
            untile=untile,
        )


def _run(rays: Rays, tb: TreeletBvh, frame, any_hit: bool, K: int = K_EMIT,
         seed_t=None, hits=None):
    """(best t, best pid as f32, converged) per ray. ``hits`` is the hits
    function (default ``super_hits.hits2``; ``hits2_reference`` traces the
    same wavefront with the plain twin). The any-hit query runs
    ``super_occluded.occluded`` when ``hits`` is None, and its twin route
    (``occluded_reference``: ``hits`` over the culled list, then the
    id-order rounds) when ``hits`` is given."""
    em = emissions(rays, tb, frame, any_hit, K, seed_t)
    n_super = em.n_super
    if any_hit:
        if hits is None:
            bt, bp, conv_super = super_occluded.occluded(tb, em, MAX_ROUNDS)
        else:
            bt, bp, conv_super = super_occluded.occluded_reference(
                tb, em, MAX_ROUNDS, hits=hits)
        conv = em.untile(conv_super[:, None].expand(n_super, SUPER))
        return em.untile(bt), em.untile(bp), conv

    hits = hits if hits is not None else super_hits.hits2
    args = (em.o, em.d, em.tmin)
    bt, bp = hits(tb, em.ids, em.enear, em.en, em.gm, *args, em.bt0, em.bp0,
                  any_hit)

    if em.seeded is not None:
        # Exact repair: a seeded lane that found nothing under its clamped
        # window may have its true hit in (seed, tmax]; re-dispatch the same
        # emission list with the full window for exactly those lanes and a
        # dead window for the rest.
        unresolved = (bp < 0.0) & em.seeded
        if obs.host_read("flat.repair", unresolved.any()):
            btr, bpr = hits(
                tb, em.ids, em.enear,
                torch.where(unresolved.any(dim=1), em.en, 0).to(torch.int32),
                em.gm, *args,
                torch.where(unresolved, em.tmax, -_INF),
                torch.full_like(bp, -1.0), any_hit,
            )
            bt = torch.where(unresolved, btr, bt)
            bp = torch.where(unresolved, bpr, bp)

    # Overflow super-tiles (survivors > K) sweep all quarter blocks in id
    # order; a clipped traversal is flagged, never silent.
    bt, bp, conv_super = super_hits.sweep(hits, tb, em.ids.shape[1], em.overflow,
                                          *args, bt, bp, any_hit, MAX_ROUNDS)
    conv = em.untile(conv_super[:, None].expand(n_super, SUPER))
    return em.untile(bt), em.untile(bp), conv


def closest_hit(rays: Rays, tb: TreeletBvh, frame=None, with_conv=False,
                seed_t=None, hits=None):
    """(t, prim_id) closest hit; prim_id == -1 on miss. Exact (the cull is
    conservative; the per-ray hits kernel decides). ``seed_t``: optional
    (N,) per-ray upper-bound hint (0 = none), exact whatever its quality.
    ``with_conv=True`` also returns the per-ray converged flag."""
    bt, bp, conv = _run(rays, tb, frame, any_hit=False, seed_t=seed_t,
                        hits=hits)
    pid = bp.to(torch.int32)
    t = torch.where(pid >= 0, bt, rays.tmax)
    if with_conv:
        return t, pid, conv
    return t, pid


def any_hit(rays: Rays, tb: TreeletBvh, frame=None, with_conv=False, hits=None):
    """Occlusion query over [tmin, tmax]; ``hits`` as in ``closest_hit``."""
    _, bp, conv = _run(rays, tb, frame, any_hit=True, hits=hits)
    if with_conv:
        return bp > 0.0, conv
    return bp > 0.0

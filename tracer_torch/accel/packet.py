"""Tile-packet traversal over a treelet-cut BVH (port of
``tracer.accel.packet``), the mesh engine of path mode.

* Rays are grouped into tiles of 128 (8x16 pixel packets of a frame, or
  consecutive lanes of another wavefront). A tile shares one walk of the
  top tree (phase A): an 8-wide slab test of every child box against all
  its rays, descent into the nearest inner child, sibling stacks per level,
  and treelet children *emitted* to a per-tile list in near order.
* The emitted blocks are intersected by the treelet hits kernel
  (``tracer_torch.kernels.treelet_hits.hits``, phase B), per-ray exact.
* A tile pauses when its emission list may overflow (``K_EMIT``); after
  phase B tightens its rays' best t, the walk resumes with the tighter
  pruning bound. Rounds repeat while any tile is paused.

Phase A is XLA in the JAX package. Here a walk iteration is ``_body``, in
PyTorch ops, on CPU tensors, and one hand-written CUDA kernel
(``tracer_torch.kernels.phase_a_walk``) that runs ``n`` iterations of it at
once on a CUDA device; ``_body`` is the kernel's twin, bit for bit. Every
float operation of the walk (subtract, multiply, divide, min, max) is
exactly rounded, so it emits the same blocks as the JAX package. JAX's
``while_loop`` over phase A becomes a host loop that reads its condition
every ``CHECK_EVERY`` iterations: an iteration changes nothing for a tile
that is done or paused, so the extra iterations are no-ops, and the count
never exceeds ``MAX_IT``. On a CUDA device each batch of ``CHECK_EVERY``
iterations is one launch of the kernel. The JAX package's XLA phase B is
the kernel's twin, ``treelet_hits.hits_reference``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from tracer_torch import obs
from tracer_torch.accel.treelet import TreeletBvh
from tracer_torch.kernels import phase_a_walk, treelet_hits
from tracer_torch.kernels.intersect import Rays

_INF = 3.0e38
MAX_IT = 1 << 17
TILE_H = 8
TILE_W = 16  # 16x8 pixel packets: TILE = 128 rays
TILE = TILE_H * TILE_W
K_EMIT = 64  # per-round treelet emission capacity per tile
CHUNK_TILES = 4096  # lockstep tile chunk (phase A retires chunks independently)
MAX_ROUNDS = 256
CHECK_EVERY = 4  # phase-A iterations between host reads of the loop condition


# ---------------------------------------------------------------------------
# Tile ordering: row-major pixels <-> (n_tiles, TILE) packets.
# ---------------------------------------------------------------------------


def _pads(W: int, H: int):
    Hp = -(-H // TILE_H) * TILE_H
    Wp = -(-W // TILE_W) * TILE_W
    return Hp, Wp


def to_tiles(x: torch.Tensor, W: int, H: int, fill):
    """(H*W, ...) row-major -> (n_tiles, TILE, ...), padded with ``fill``."""
    Hp, Wp = _pads(W, H)
    rest = tuple(x.shape[1:])
    img = torch.full((Hp, Wp, *rest), fill, dtype=x.dtype, device=x.device)
    img[:H, :W] = x.reshape(H, W, *rest)
    img = img.reshape(Hp // TILE_H, TILE_H, Wp // TILE_W, TILE_W, *rest)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    return img.permute(perm).reshape(-1, TILE, *rest)


def from_tiles(x: torch.Tensor, W: int, H: int):
    Hp, Wp = _pads(W, H)
    rest = tuple(x.shape[2:])
    img = x.reshape(Hp // TILE_H, Wp // TILE_W, TILE_H, TILE_W, *rest)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    img = img.permute(perm).reshape(Hp, Wp, *rest)
    return img[:H, :W].reshape(H * W, *rest)


def _linear_tiles(x: torch.Tensor, fill):
    """Tiling of a wavefront that is not a frame: consecutive lanes."""
    n = x.shape[0]
    pad = (-n) % TILE
    if pad:
        x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(-1, TILE, *x.shape[1:])


# ---------------------------------------------------------------------------
# Phase A: lockstep packet traversal of the top tree (per tile chunk).
# ---------------------------------------------------------------------------


@dataclass
class TravState:
    """Resumable per-tile traversal state of one chunk of C tiles; updated
    in place by phase A."""

    cur: torch.Tensor  # (C,) i64 current top row
    level: torch.Tensor  # (C,) i64
    asc: torch.Tensor  # (C,) bool: ascending (pop the next sibling)
    done: torch.Tensor  # (C,) bool: traversal exhausted
    paused: torch.Tensor  # (C,) bool: emission list full
    snear: torch.Tensor  # (C, D, 8) f32 sibling-stack nears
    sref: torch.Tensor  # (C, D, 8) i64 sibling-stack row refs


def _init_state(C: int, D: int, device) -> TravState:
    z = lambda dtype: torch.zeros(C, dtype=dtype, device=device)
    return TravState(
        cur=z(torch.int64),
        level=z(torch.int64),
        asc=z(torch.bool),
        done=z(torch.bool),
        paused=z(torch.bool),
        snear=torch.full((C, D, 8), _INF, dtype=torch.float32, device=device),
        sref=torch.full((C, D, 8), -1, dtype=torch.int64, device=device),
    )


_STATE = [f.name for f in fields(TravState)]


class _Walk:
    """Phase A's fixed buffers for one chunk shape (C tiles, stack depth D,
    K emissions) of one tree: the walk's inputs, a chunk's ``TravState``
    and the round's emissions. A call copies its chunk in, iterates the
    walk on them (``_iterate``) and copies the state out. They are made
    once per tree, device and shape and kept (``TreeletBvh.walks``), so a
    chunk allocates nothing and builds no index table (``rows``, ``kiota``,
    ``slot8``)."""

    def __init__(self, tb: TreeletBvh, C: int, D: int, K: int, dev: torch.device):
        self.top, self.top_ref, self.D, self.K = tb.top, tb.top_ref, D, K
        f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        self.o, self.inv_d = f32(C, TILE, 3), f32(C, TILE, 3)
        self.tmin, self.prune, self.amax = f32(C, TILE), f32(C, TILE), f32(C)
        self.rows = torch.arange(C, device=dev)
        self.kiota = torch.arange(K, device=dev)[None, :]
        self.slot8 = torch.arange(8, device=dev)[None, :]
        self.st = _init_state(C, D, dev)
        self.eids = torch.zeros((C, K), dtype=torch.int64, device=dev)
        self.enear = f32(C, K)
        self.en = torch.zeros(C, dtype=torch.int64, device=dev)

    def load(self, st: TravState, o, d, tmin, prune) -> None:
        self.o.copy_(o)
        self.inv_d.copy_(1.0 / d)
        self.tmin.copy_(tmin)
        self.prune.copy_(prune)
        torch.amax(prune, dim=1, out=self.amax)  # loosest per-ray bound, for the ascent
        for f in _STATE:
            getattr(self.st, f).copy_(getattr(st, f))
        self.st.paused.zero_()
        self.eids.zero_()
        self.enear.fill_(_INF)
        self.en.zero_()

    def store(self, st: TravState) -> None:
        for f in _STATE:
            getattr(st, f).copy_(getattr(self.st, f))


def _walk(tb: TreeletBvh, C: int, D: int, K: int, dev: torch.device) -> _Walk:
    key = (dev, C, D, K)
    if key not in tb.walks:
        tb.walks[key] = _Walk(tb, C, D, K, dev)
    return tb.walks[key]


def _iterate(wk: _Walk, n: int) -> None:
    """``n`` iterations of the walk on ``wk``'s buffers: ``_body`` ``n``
    times on CPU tensors, one launch of the walk kernel on a CUDA device."""
    if wk.o.device.type == "cpu":
        for _ in range(n):
            _body(wk)
        return
    phase_a_walk.walk(wk, n)


def _body(wk: _Walk) -> None:
    """One iteration of the walk, in place on ``wk``'s buffers: the CPU's
    walk and the walk kernel's plain twin."""
    st, top, top_ref, slot8, kiota = wk.st, wk.top, wk.top_ref, wk.slot8, wk.kiota
    R, D, K = top.shape[0], wk.D, wk.K
    o_ = wk.o[:, None, :, :]
    inv_ = wk.inv_d[:, None, :, :]
    tmin_ = wk.tmin[:, None, :]
    prune_ = wk.prune[:, None, :]

    active = ~st.done & ~st.paused
    visit = active & ~st.asc
    curc = st.cur.clamp(0, R - 1)
    row = top[curc]  # (C, 8, 8)
    ref = top_ref[curc]  # (C, 8)

    # 8-wide slab test against every ray of the tile: (C, 8, TILE).
    t0 = (row[:, :, None, 0:3] - o_) * inv_
    t1 = (row[:, :, None, 3:6] - o_) * inv_
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    ray_ok = (near <= far) & (far >= tmin_) & (near < prune_)
    child_hit = ray_ok.any(dim=-1)  # (C, 8)
    child_near = torch.where(ray_ok, torch.clamp_min(near, 0.0), _INF).amin(dim=-1)

    hit_v = visit[:, None] & child_hit
    tre_key = torch.where(hit_v & (ref <= -2), child_near, _INF)
    ikey = torch.where(hit_v & (ref >= 0), child_near, _INF)

    # Emit treelet children in near order (selection over 8 slots).
    tids = -2 - ref
    n_add = torch.zeros_like(wk.en)
    for _ in range(8):
        sel = slot8 == tre_key.argmin(dim=1)[:, None]
        mn = tre_key.amin(dim=1)
        live = mn < _INF
        tid = torch.where(sel, tids, 0).sum(dim=1)
        w = (kiota == (wk.en + n_add)[:, None]) & live[:, None]
        torch.where(w, tid[:, None], wk.eids, out=wk.eids)
        torch.where(w, mn[:, None], wk.enear, out=wk.enear)
        n_add = n_add + live.long()
        tre_key = torch.where(sel, _INF, tre_key)
    wk.en += n_add

    # Descend into the nearest inner child; park its siblings at
    # stack[level].
    c_sel = slot8 == ikey.argmin(dim=1)[:, None]
    has_child = visit & (ikey.amin(dim=1) < _INF)
    c_ref = torch.where(c_sel, ref, 0).sum(dim=1)

    # Ascend: pop the nearest unconsumed sibling at this level, pruned
    # against the loosest per-ray bound (conservative).
    lvl = st.level.clamp(0, D - 1)
    s_near = st.snear[wk.rows, lvl]  # (C, 8)
    s_ref = st.sref[wk.rows, lvl]
    a_key = torch.where(s_near < wk.amax[:, None], s_near, _INF)
    a_sel = slot8 == a_key.argmin(dim=1)[:, None]
    a_has = st.asc & active & (a_key.amin(dim=1) < _INF)
    a_ref = torch.where(a_sel, s_ref, 0).sum(dim=1)

    new_near = torch.where(
        has_child[:, None],
        torch.where(c_sel, _INF, ikey),
        torch.where(a_has[:, None] & a_sel, _INF, s_near),
    )
    st.snear[wk.rows, lvl] = new_near
    st.sref[wk.rows, lvl] = torch.where(has_child[:, None], ref, s_ref)

    # Transitions: ``done`` reads the new level, ``paused`` the new done and
    # emission count.
    go_asc = (visit & ~has_child) | (st.asc & active & ~a_has)
    descend = has_child | a_has
    torch.where(has_child, c_ref, torch.where(a_has, a_ref, st.cur), out=st.cur)
    torch.where(descend, lvl + 1, torch.where(go_asc, st.level - 1, st.level), out=st.level)
    st.asc.copy_(torch.where(descend, False, torch.where(go_asc, True, st.asc)))
    st.done |= go_asc & (st.level < 0)
    # Pause before visiting a node that might not fit 8 more emissions.
    st.paused |= active & ~st.done & (wk.en > K - 8)


def _phase_a_chunk(tb: TreeletBvh, D: int, K: int, st: TravState, o, d, tmin, prune):
    """Run one chunk of tiles until every tile is done or paused.

    ``prune``: (C, TILE) per-ray upper bound on a useful t (the best t so
    far for closest hit; -inf for occluded lanes in any-hit mode). Updates
    ``st`` in place and returns this round's emissions (ids (C, K), nears
    (C, K), counts (C,)). Each batch of up to ``CHECK_EVERY`` iterations
    goes through ``_iterate``.
    """
    with obs.span("packet.phase_a"), torch.no_grad():
        wk = _walk(tb, o.shape[0], D, K, o.device)
        wk.load(st, o, d, tmin, prune)
        it = 0
        while it < MAX_IT and obs.host_read("packet.walk", (~wk.st.done & ~wk.st.paused).any()):
            n = min(CHECK_EVERY, MAX_IT - it)
            obs.count("packet.phase_a_iterations", n)
            _iterate(wk, n)
            it += n
        wk.store(st)
        return wk.eids.clone(), wk.enear.clone(), wk.en.clone()


# ---------------------------------------------------------------------------
# Phase B: the treelet hits kernel (its twin serves CPU tensors).
# ---------------------------------------------------------------------------


def _dispatch_hits(tb, eids, enear, en, o, d, tmin, best_t, best_pid, any_hit):
    with obs.span("packet.phase_b"):
        return treelet_hits.hits(tb, eids, en, o, d, tmin, best_t, best_pid, any_hit,
                                 enear=enear)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def _run(rays: Rays, tb: TreeletBvh, frame, any_hit: bool):
    n = rays.o.shape[0]
    if frame is not None and frame[0] * frame[1] == n:
        W, H = frame
        tile = lambda x, fill: to_tiles(x, W, H, fill)
        untile = lambda x: from_tiles(x, W, H)
    else:
        tile = _linear_tiles
        untile = lambda x: x.reshape(-1)[:n]

    # Dead padding rays: origin far outside, window empty, so every test
    # fails.
    o = tile(rays.o, 1.0e30)
    d = tile(rays.d, 1.0)
    tmin = tile(rays.tmin, 1.0)
    tmax = tile(rays.tmax, 0.0)
    n_tiles = o.shape[0]
    dev = o.device

    C = min(CHUNK_TILES, n_tiles)
    pad = (-n_tiles) % C
    if pad:
        full = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=dev)
        o = torch.cat([o, full((pad, TILE, 3), 1.0e30)])
        d = torch.cat([d, full((pad, TILE, 3), 1.0)])
        tmin = torch.cat([tmin, full((pad, TILE), 1.0)])
        tmax = torch.cat([tmax, full((pad, TILE), 0.0)])
    nc = (n_tiles + pad) // C

    D = max(tb.depth, 1)
    states = [_init_state(C, D, dev) for _ in range(nc)]
    bt = tmax.clone()  # closest: prune at the current best; any-hit: window top
    bp = torch.full((nc * C, TILE), -1.0, dtype=torch.float32, device=dev)

    def round_body(bt, bp):
        prune = torch.where(bp > 0.0, -_INF, tmax) if any_hit else bt
        ems = [
            _phase_a_chunk(tb, D, K_EMIT, states[c], o[c * C:(c + 1) * C],
                           d[c * C:(c + 1) * C], tmin[c * C:(c + 1) * C],
                           prune[c * C:(c + 1) * C])
            for c in range(nc)
        ]
        eids = torch.cat([e[0] for e in ems])
        en = torch.cat([e[2] for e in ems])
        # Walk emissions are only approximately near-ordered: the kernel's
        # monotone early break would be unsound here, so no nears are
        # passed.
        return _dispatch_hits(tb, eids, None, en, o, d, tmin, bt, bp, any_hit)

    bt, bp = round_body(bt, bp)
    # Round bound scaled to the structure: a pathological tile may need to
    # emit every treelet, i.e. ceil(NT / K_EMIT) rounds.
    max_rounds = max(MAX_ROUNDS, -(-tb.NT * 2 // K_EMIT) + 8)
    rounds = 1
    while rounds < max_rounds and any(obs.host_read("packet.rounds", s.paused.any())
                                      for s in states):
        bt, bp = round_body(bt, bp)
        rounds += 1

    bt = untile(bt[:n_tiles])
    bp = untile(bp[:n_tiles])
    # A tile whose walk finished is done; one cut off by the round cap (still
    # paused) or the iteration cap (neither) is truncated: report it.
    done = torch.cat([s.done for s in states])[:n_tiles]
    conv = untile(done[:, None].expand(n_tiles, TILE))
    return bt, bp, conv


def closest_hit(rays: Rays, tb: TreeletBvh, frame=None, with_conv=False):
    """(t, prim_id) closest hit; prim_id == -1 on a miss.

    ``frame=(W, H)``: when the wavefront is a full row-major frame, rays
    are grouped into 8x16 pixel packets; otherwise packets are consecutive
    lanes. ``with_conv=True`` also returns the per-ray convergence flag
    (False = the walk was cut off by a cap).
    """
    bt, bp, conv = _run(rays, tb, frame, any_hit=False)
    pid = bp.to(torch.int32)
    t = torch.where(pid >= 0, bt, rays.tmax)
    if with_conv:
        return t, pid, conv
    return t, pid


def any_hit(rays: Rays, tb: TreeletBvh, frame=None, with_conv=False):
    """Occlusion query over [tmin, tmax]."""
    _, bp, conv = _run(rays, tb, frame, any_hit=True)
    if with_conv:
        return bp > 0.0, conv
    return bp > 0.0

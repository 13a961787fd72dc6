"""The wide (8-ary) BVH, ``traversal="bvh8"`` (port of
``tracer.accel.wide``), in NumPy (build) and PyTorch ops (traversal).

One 96-word float32 row per node, integers bitcast into it:

  [0]  parent ref (i32; -1 at root)
  [1]  leaf count (i32; 0 => inner node)
  inner: [2 .. 50)  8 children x (minx,miny,minz,maxx,maxy,maxz)
         [50 .. 58) 8 children refs (i32; -1 empty, else row index)
  leaf:  [2 .. 74)  8 triangles x 9 vertex floats (v0,v1,v2)
         [74 .. 82) 8 original triangle ids (i32; -1 padding)

``build`` collapses the port's binary LBVH into that table exactly as the
JAX package does (the tables are equal bit for bit). The traversal is the
JAX package's ordered depth-first walk with a per-level sibling stack:
every lane of a chunk advances in lockstep, one row gather per step; an
inner row slab-tests its 8 children and descends into the nearest, parking
the rest at its level; a finished subtree ascends and takes the nearest
parked sibling still in front of the best hit. A finished lane's step
changes nothing, so the host reads "is any lane still walking" only every
``CHECK_EVERY`` steps. A lane still walking after ``MAX_ITERS`` steps is
truncated and reported (``converged`` False), and the integrator paints it
magenta. The walk carries no gradient: it returns ids and t.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from tracer_torch.accel.lbvh import BvhBuffers
from tracer_torch.accel.treelet import _subtree_prims
from tracer_torch.kernels.intersect import Rays
from tracer_torch.math import vec

ROW = 96
B = 8  # branching factor
K = 8  # max triangles per leaf row
MAX_LEVELS = 16
_INF = 3.0e38

# Safety cap far above any real traversal, as in the JAX package.
MAX_ITERS = 1 << 17
# Lanes walked together. Each chunk stops at its own deepest lane; the JAX
# package takes 16,384 (its ``lax.map`` over chunks), here chunks are larger
# because every step of a chunk costs a few dozen kernel launches whatever
# its width. A lane's result does not depend on its chunk.
CHUNK = 1 << 16
CHECK_EVERY = 16


@dataclass(frozen=True)
class WideBvh:
    table: torch.Tensor  # (M, 96) f32
    depth: int = MAX_LEVELS


def build_table(bvh: BvhBuffers, vertices: np.ndarray, indices: np.ndarray):
    """The (M, 96) float32 row table of ``bvh`` and its depth (the JAX
    package's ``build``, in NumPy). Greedy expansion: starting from a binary
    node, repeatedly split the child subtree with the most primitives until
    8 slots are filled; any slot whose subtree holds <= 8 primitives becomes
    a packed leaf row."""
    sub_first, sub_count = _subtree_prims(bvh)
    verts = np.asarray(vertices, np.float32)
    idx = np.asarray(indices, np.int64)
    prim_ids = bvh.prim_ids.astype(np.int64)
    rows: list[np.ndarray] = []

    def new_row(parent: int) -> int:
        r = np.zeros(ROW, np.float32)
        r[0] = np.int32(parent).view(np.float32)
        rows.append(r)
        return len(rows) - 1

    def fill_leaf(row_id: int, first: int, count: int) -> None:
        r = rows[row_id]
        r[1] = np.int32(count).view(np.float32)
        ids = prim_ids[first:first + count]
        r[2:2 + count * 9] = verts[idx[ids].reshape(-1)].reshape(-1)
        pid = np.full(K, -1, np.int32)
        pid[:count] = ids.astype(np.int32)
        r[74:82] = pid.view(np.float32)

    max_depth = 0

    def emit(node: int, parent_row: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        me = new_row(parent_row)
        if sub_count[node] <= K:
            fill_leaf(me, int(sub_first[node]), int(sub_count[node]))
            return me
        slots = [node]
        while len(slots) < B:
            cand = [s for s in slots if bvh.count[s] == 0 and sub_count[s] > K]
            if not cand:
                break
            s = max(cand, key=lambda x: sub_count[x])
            slots.remove(s)
            slots.extend([int(bvh.left[s]), int(bvh.right[s])])
        r = rows[me]
        refs = np.full(B, -1, np.int32)
        for ci, s in enumerate(slots):
            r[2 + ci * 6:2 + ci * 6 + 3] = bvh.node_min[s]
            r[2 + ci * 6 + 3:2 + ci * 6 + 6] = bvh.node_max[s]
            refs[ci] = emit(s, me, depth + 1)
        rows[me][50:58] = refs.view(np.float32)
        return me

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(0, -1, 1)
    finally:
        sys.setrecursionlimit(old)
    if max_depth > MAX_LEVELS:
        raise ValueError(f"wide BVH depth {max_depth} > {MAX_LEVELS}")
    return np.stack(rows), max_depth


def build(bvh: BvhBuffers, vertices: np.ndarray, indices: np.ndarray, device) -> WideBvh:
    """The wide BVH of ``bvh`` with its table on ``device``."""
    table, depth = build_table(bvh, vertices, indices)
    return WideBvh(table=torch.as_tensor(table, device=device), depth=depth)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _traverse(rays: Rays, wb: WideBvh, any_hit: bool):
    """The walk over one chunk; returns (t, prim id or -1, converged)."""
    n, dev = rays.o.shape[0], rays.o.device
    table = wb.table
    D = max(int(wb.depth), 1)
    o, d, tmin0 = rays.o, rays.d, rays.tmin
    inv_d = 1.0 / d
    ar = torch.arange(n, device=dev)
    s = dict(
        cur=torch.zeros(n, dtype=torch.int64, device=dev),
        level=torch.zeros(n, dtype=torch.int64, device=dev),
        asc=torch.zeros(n, dtype=torch.bool, device=dev),
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        snear=torch.full((n, D, B), _INF, dtype=torch.float32, device=dev),
        sref=torch.full((n, D, B), -1, dtype=torch.int32, device=dev),
        best_t=rays.tmax.clone(),
        best_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
    )
    slot = torch.arange(K, device=dev)

    def step():
        cur, level, asc, done = s["cur"], s["level"], s["asc"], s["done"]
        best_t, best_id = s["best_t"], s["best_id"]
        visit = ~done & ~asc
        row = table[cur.clamp(0, table.shape[0] - 1)]  # (n, 96)
        leaf_count = _i32(row[:, 1])
        is_leaf = visit & (leaf_count > 0)

        # Leaf: K triangles of the row, vectorized over the slot axis.
        tri = row[:, 2:74].reshape(n, K, 9)
        pid = _i32(row[:, 74:82])
        v0, v1, v2 = tri[:, :, 0:3], tri[:, :, 3:6], tri[:, :, 6:9]
        e0, e1 = v1 - v0, v2 - v0
        o_to_v0 = v0 - o[:, None, :]
        nrm = vec.cross(e0, e1)
        nom = vec.cross(o_to_v0, d[:, None, :].expand_as(o_to_v0))
        inv = 1.0 / vec.dot(d[:, None, :], nrm)
        beta = vec.dot(nom, e1) * inv
        gamma = -vec.dot(nom, e0) * inv
        t = vec.dot(o_to_v0, nrm) * inv
        ok = (is_leaf[:, None] & (slot < leaf_count[:, None]) & (pid >= 0)
              & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
              & (t >= tmin0[:, None]) & (t <= best_t[:, None]))
        tcand = torch.where(ok, t, _INF)
        kmin, karg = tcand.min(dim=1)
        got = kmin < best_t
        best_id = torch.where(got, pid[ar, karg], best_id)
        best_t = torch.where(got, kmin, best_t)

        # Inner: 8-wide slab test, descend into the nearest child.
        boxes = row[:, 2:50].reshape(n, B, 6)
        refs = _i32(row[:, 50:58])
        t0 = (boxes[:, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
        t1 = (boxes[:, :, 3:6] - o[:, None, :]) * inv_d[:, None, :]
        near = torch.minimum(t0, t1).amax(dim=-1)
        far = torch.maximum(t0, t1).amin(dim=-1)
        child_ok = ((refs >= 0) & (near <= far) & (far >= tmin0[:, None])
                    & (near < best_t[:, None]))
        tkey = torch.where(child_ok, torch.clamp_min(near, 0.0), _INF)
        c_key, c_arg = tkey.min(dim=1)
        has_child = visit & ~is_leaf & (c_key < _INF)
        c_ref = refs[ar, c_arg]

        # The sibling stack at the lane's level.
        lvl = level.clamp(0, D - 1)
        s_near = s["snear"][ar, lvl]
        s_ref = s["sref"][ar, lvl]
        a_key = torch.where(s_near < best_t[:, None], s_near, _INF)
        a_min, a_arg = a_key.min(dim=1)
        a_has = asc & ~done & (a_min < _INF)
        a_ref = s_ref[ar, a_arg]
        c_sel = slot == c_arg[:, None]
        a_sel = slot == a_arg[:, None]
        new_near = torch.where(has_child[:, None], torch.where(c_sel, _INF, tkey),
                               torch.where(a_has[:, None] & a_sel, _INF, s_near))
        s["snear"][ar, lvl] = new_near
        s["sref"][ar, lvl] = torch.where(has_child[:, None], refs, s_ref)

        # Transitions.
        go_asc = (visit & ~has_child) | (asc & ~done & ~a_has)
        descend = has_child | a_has
        if any_hit:
            retired = ~done & (best_id >= 0)
            go_asc = go_asc & ~retired
            descend = descend & ~retired
            done = done | retired
        s["cur"] = torch.where(has_child, c_ref, torch.where(a_has, a_ref, cur.to(torch.int32))
                               ).long()
        level = torch.where(descend, lvl + 1, torch.where(go_asc, level - 1, level))
        s["asc"] = torch.where(descend, False, torch.where(go_asc, True, asc))
        s["done"] = done | (go_asc & (level < 0))
        s["level"], s["best_t"], s["best_id"] = level, best_t, best_id

    it = 0
    while it < MAX_ITERS and not bool(s["done"].all()):
        for _ in range(min(CHECK_EVERY, MAX_ITERS - it)):
            step()
        it += min(CHECK_EVERY, MAX_ITERS - it)
    return s["best_t"], s["best_id"], s["done"]


@torch.no_grad()
def _traverse_chunked(rays: Rays, wb: WideBvh, any_hit: bool, chunk: int):
    n = rays.o.shape[0]
    parts = [_traverse(Rays(rays.o[i:i + chunk], rays.d[i:i + chunk], rays.tmin[i:i + chunk],
                            rays.tmax[i:i + chunk]), wb, any_hit)
             for i in range(0, n, chunk)]
    if not parts:
        e = rays.tmax.new_empty(0)
        return e, e.to(torch.int32), e.to(torch.bool)
    return tuple(torch.cat(p) for p in zip(*parts))


def closest_hit(rays: Rays, wb: WideBvh, chunk: int | None = None, with_conv=False):
    """(t, prim_id) closest hit; prim_id == -1 on miss. ``with_conv=True``
    adds the per-lane truncation flag (False = cut off by ``MAX_ITERS``)."""
    t, pid, conv = _traverse_chunked(rays, wb, False, chunk or CHUNK)
    return (t, pid, conv) if with_conv else (t, pid)


def any_hit(rays: Rays, wb: WideBvh, chunk: int | None = None, with_conv=False):
    """Occlusion over [tmin, tmax]: (blocked[, converged])."""
    _, pid, conv = _traverse_chunked(rays, wb, True, chunk or CHUNK)
    return (pid >= 0, conv) if with_conv else pid >= 0

"""BSP tree (port of ``tracer.accel.bsp``): the NumPy builder, bit for bit
the JAX package's, and the lockstep walk in PyTorch ops.

The builder reproduces the course BSP of the reference
(``reference/src/data_structures/bsp_tree.rs:45-323``): a top-down spatial
partition, cost = count * area over 3 axes x 3 candidate planes
(``TESTS = 4``), the empty-side rescue that shifts the plane past the
extreme object by size/8 (at least 1e-6), and a leaf when a node holds at
most ``max_objects`` or sits at ``max_depth``. Objects straddling the plane
go to both children. The tree is stored compactly: depth-first order with
explicit child links.

The walk mirrors ``intersect_trimesh`` (``res/shaders/bsp.wgsl:10-81``):
each ray's interval is first clamped to the scene box
(``aabb.wgsl:8-31``); then near/far children by the sign of the ray's
direction, the plane's t against the current [tmin, tmax], a branch stack
of (node, tmin, tmax), and an early return on the first leaf that holds a
hit. Every lane advances in lockstep, one node per step, up to
``MAX_ITERS`` steps; a lane still walking then is flagged as not
converged. A finished lane's step changes nothing, so the stop test may
be read every few steps (``walk``); the BSP walk reads it every step,
because its leaf test reads the step's leaf lanes on the host anyway.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, fields

import numpy as np
import torch

from tracer_torch.kernels.intersect import Rays, triangle_t

NODE_LEAF = 3  # axis codes 0/1/2, leaf = 3 (bsp_tree.rs:14)
F_EPS = 1e-6
MAX_DEPTH_DEFAULT = 20
MAX_OBJECTS_DEFAULT = 4
TESTS = 4
MAX_ITERS = 4096


@dataclass(frozen=True)
class BspBuffers:
    """The flattened tree: NumPy arrays from ``build``, tensors after
    ``to_device``."""

    axis: object  # (M,) i32: split axis, or NODE_LEAF
    plane: object  # (M,) f32
    left: object  # (M,) i32
    right: object  # (M,) i32
    first: object  # (M,) i32: leaf range start into prim_ids
    count: object  # (M,) i32
    prim_ids: object  # (K,) i32: leaf-ordered ids (straddlers repeat)
    bbox_lo: object  # (3,) f32
    bbox_hi: object  # (3,) f32
    max_level: int = MAX_DEPTH_DEFAULT
    max_count: int = MAX_OBJECTS_DEFAULT  # largest leaf population


def _buffers(f: dict, max_depth: int) -> BspBuffers:
    counts = f["count"]
    return BspBuffers(**f, max_level=max_depth,
                      max_count=int(counts.max()) if counts.size else 0)


def build(prim_lo: np.ndarray, prim_hi: np.ndarray, max_depth: int = MAX_DEPTH_DEFAULT,
          max_objects: int = MAX_OBJECTS_DEFAULT, prefer_native: bool = True) -> BspBuffers:
    """Build the BSP over primitive AABBs: with the native C++ builder
    (``native/bsp.cpp``, which raises if it cannot be compiled or fails)
    where ``prefer_native``, else with this NumPy code. Both give the same
    tree bit for bit."""
    assert 0 < max_depth < 32, "BspTree depth must be in (0, 32)"
    if prefer_native:
        from tracer_torch.accel import native

        return _buffers(native.bsp_build(prim_lo, prim_hi, max_depth, max_objects), max_depth)

    n = prim_lo.shape[0]
    root_lo = prim_lo.min(axis=0)
    root_hi = prim_hi.max(axis=0)
    axis_l, plane_l, left_l, right_l, first_l, count_l = [], [], [], [], [], []
    prim_ids: list[int] = []

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit():
        for lst, x in ((axis_l, 0), (plane_l, 0.0), (left_l, -1), (right_l, -1),
                       (first_l, 0), (count_l, 0)):
            lst.append(x)
        return len(axis_l) - 1

    def subdivide(ids: np.ndarray, lo, hi, depth: int) -> int:
        me = emit()
        if len(ids) <= max_objects or depth == max_depth:
            axis_l[me] = NODE_LEAF
            first_l[me] = len(prim_ids)
            count_l[me] = len(ids)
            prim_ids.extend(int(i) for i in ids)
            return me
        blo = prim_lo[ids]
        bhi = prim_hi[ids]
        best = (np.inf, 0, 0.0, 0, 0)
        for ax in range(3):
            for k in range(1, TESTS):
                center = (hi[ax] - lo[ax]) * (k / TESTS) + lo[ax]
                l_hi = hi.copy()
                l_hi[ax] = center
                r_lo = lo.copy()
                r_lo[ax] = center
                # Bbox::intersects is a closed-interval overlap test
                # (bbox.rs:151-155); against the child half-spaces it
                # reduces to these comparisons.
                lcnt = int((blo[:, ax] <= center).sum())
                rcnt = int((bhi[:, ax] >= center).sum())
                cost = lcnt * area(lo, l_hi) + rcnt * area(r_lo, hi)
                if cost < best[0]:
                    best = (cost, ax, center, lcnt, rcnt)
        _, ax, center, lcnt, rcnt = best
        size = hi[ax] - lo[ax]
        diff = size / 8.0 if F_EPS < size / 8.0 else F_EPS
        if lcnt == 0:
            center = float(blo[:, ax].min()) - diff
        if rcnt == 0:
            center = float(bhi[:, ax].max()) + diff
        l_hi = hi.copy()
        l_hi[ax] = center
        r_lo = lo.copy()
        r_lo[ax] = center
        lmask = blo[:, ax] <= center
        rmask = bhi[:, ax] >= center
        axis_l[me] = ax
        plane_l[me] = float(center)
        left_l[me] = subdivide(ids[lmask], lo, l_hi, depth + 1)
        right_l[me] = subdivide(ids[rmask], r_lo, hi, depth + 1)
        return me

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        subdivide(np.arange(n), root_lo.copy(), root_hi.copy(), 0)
    finally:
        sys.setrecursionlimit(old_limit)
    i32 = lambda x: np.asarray(x, np.int32)
    return _buffers(dict(
        axis=i32(axis_l), plane=np.asarray(plane_l, np.float32), left=i32(left_l),
        right=i32(right_l), first=i32(first_l), count=i32(count_l), prim_ids=i32(prim_ids),
        bbox_lo=root_lo.astype(np.float32), bbox_hi=root_hi.astype(np.float32),
    ), max_depth)


def build_for_mesh(mesh, max_depth=MAX_DEPTH_DEFAULT, max_objects=MAX_OBJECTS_DEFAULT,
                   prefer_native: bool = True) -> BspBuffers:
    lo, hi = mesh.bboxes()
    return build(lo, hi, max_depth, max_objects, prefer_native)


def validate(bsp: BspBuffers, num_prims: int) -> None:
    """The reference's test invariants: every primitive lies in at least one
    leaf (bsp_tree.rs:357-392), and the leaf ranges are disjoint slices of
    ``prim_ids`` (:395-420)."""
    leaf = bsp.axis == NODE_LEAF
    seen = np.zeros(num_prims, bool)
    total = 0
    for i in np.nonzero(leaf)[0]:
        ids = bsp.prim_ids[bsp.first[i]: bsp.first[i] + bsp.count[i]]
        seen[ids] = True
        total += len(ids)
    assert seen.all(), "every primitive must appear in some leaf"
    assert total == len(bsp.prim_ids)
    internal = ~leaf
    assert (bsp.left[internal] >= 0).all() and (bsp.right[internal] >= 0).all()


def as_tensor(x, device) -> torch.Tensor:
    """A host array as a tensor on ``device``: float32, or int64 (ready to
    index with) for integer arrays."""
    x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.float32 if x.dtype.kind == "f" else torch.int64,
                           device=device)


def to_device(bsp, device) -> BspBuffers:
    """The tree's arrays as tensors on ``device`` (``as_tensor``). Reads any
    object with the fields of ``BspBuffers`` whose arrays are NumPy arrays
    (the JAX package's too)."""
    return BspBuffers(**{f.name: int(getattr(bsp, f.name)) if f.type == "int"
                         else as_tensor(getattr(bsp, f.name), device)
                         for f in fields(BspBuffers)})


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def _aabb_clamp(rays: Rays, lo, hi):
    """``intersect_min_max`` (aabb.wgsl:8-31): the ray's interval clamped to
    the scene box, widened by 1e-4. Returns (tmin, tmax, hit)."""
    inv_d = 1.0 / rays.d
    t0 = (lo - rays.o) * inv_d
    t1 = (hi - rays.o) * inv_d
    ok = torch.abs(rays.d) > 1.0e-8
    tmin = torch.where(ok, torch.minimum(t0, t1), 1e32).amin(dim=-1)
    tmax = torch.where(ok, torch.maximum(t0, t1), -1e32).amax(dim=-1)
    hit = ~((tmin > tmax) | (tmin > rays.tmax) | (tmax < rays.tmin))
    new_tmin = torch.maximum(tmin - 1e-4, rays.tmin)
    new_tmax = torch.minimum(tmax + 1e-4, rays.tmax)
    return torch.where(hit, new_tmin, rays.tmin), torch.where(hit, new_tmax, rays.tmax), hit


def _leaf_hits(rays: Rays, bsp: BspBuffers, vertices, indices, node, do_leaf, best_t,
               best_id):
    """The triangles of each ``do_leaf`` lane's leaf against its ray up to
    ``best_t``. Returns (best_t', best_id', found).

    The JAX package tests slot k of every lane's leaf in pass k, up to the
    largest leaf (``max_count``, 187 on the bunny stand-in and 1,233 on the
    dragon's), keeping a strictly nearer hit. Here the (lane, slot) pairs of
    the leaf lanes alone are tested at once: the same triangles against the
    same window, and per lane the nearest t, taken from the first slot that
    reaches it, which is what the passes keep (a hit's t does not depend on
    the window)."""
    n, dev = do_leaf.shape[0], do_leaf.device
    lanes = torch.nonzero(do_leaf)[:, 0]
    counts = bsp.count[node[lanes]]
    lane = torch.repeat_interleave(lanes, counts)
    p = lane.shape[0]
    if p == 0:
        return best_t, best_id, torch.zeros(n, dtype=torch.bool, device=dev)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    pid = bsp.prim_ids[bsp.first[node[lane]] + torch.arange(p, device=dev) - starts]
    tri = indices[pid].long()
    t, _, _, ok = triangle_t(
        Rays(rays.o[lane], rays.d[lane], rays.tmin[lane], best_t[lane]),
        vertices[tri[:, 0]], vertices[tri[:, 1]], vertices[tri[:, 2]])
    inf = torch.tensor(float("inf"), device=dev)
    nearest = torch.full((n,), float("inf"), device=dev).scatter_reduce(
        0, lane, torch.where(ok, t, inf), "amin")
    at_nearest = ok & (t == nearest[lane])
    pair = torch.arange(p, device=dev)
    win = torch.full((n,), p, device=dev).scatter_reduce(
        0, lane, torch.where(at_nearest, pair, p), "amin")
    found = win < p
    best_id = torch.where(found, pid[win.clamp(max=p - 1)], best_id)
    return torch.where(found, nearest, best_t), best_id, found


def _step(rays: Rays, bsp: BspBuffers, vertices, indices, s: dict) -> None:
    """One lockstep step of every lane, updating the walk state ``s`` in
    place (``tracer/accel/bsp.py:_traverse``'s loop body)."""
    n = rays.o.shape[0]
    depth = s["st_node"].shape[1]
    cur, sp, tmin, tmax = s["cur"], s["sp"], s["tmin"], s["tmax"]
    active = cur >= 0
    node = cur.clamp(0, bsp.axis.shape[0] - 1)
    ax = bsp.axis[node]
    is_leaf = ax == NODE_LEAF

    do_leaf = active & is_leaf
    best_t, best_id, found = _leaf_hits(rays, bsp, vertices, indices, node, do_leaf,
                                        s["best_t"], s["best_id"])
    # A leaf with any hit retires the lane (the interval clipping visits
    # leaves front to back).
    retire = do_leaf & found

    # A leaf without one pops the stack, or ends the walk.
    can_pop = do_leaf & ~found & (sp > 0)
    sp_pop = torch.where(can_pop, sp - 1, sp)
    slot = sp_pop.clamp(0, depth - 1)[:, None]
    popped_node = s["st_node"].gather(1, slot)[:, 0]
    popped_tmin = s["st_tmin"].gather(1, slot)[:, 0]
    popped_tmax = s["st_tmax"].gather(1, slot)[:, 0]

    # An internal node: near and far child by the direction's sign, and the
    # plane's t against the interval.
    axc = ax.clamp(0, 2)[:, None]
    d_ax = rays.d.gather(1, axc)[:, 0]
    o_ax = rays.o.gather(1, axc)[:, 0]
    lchild, rchild = bsp.left[node], bsp.right[node]
    pos = d_ax >= 0.0
    near = torch.where(pos, lchild, rchild)
    far = torch.where(pos, rchild, lchild)
    denom = torch.where(torch.abs(d_ax) < 1e-8, 1e-8, d_ax)
    t_plane = (bsp.plane[node] - o_ax) / denom
    go_near = t_plane > tmax
    go_far = t_plane < tmin
    descend = active & ~is_leaf
    # Both sides: push the far child with [t_plane, tmax], go near.
    push = descend & ~go_near & ~go_far & (sp < depth)
    slot_push = sp.clamp(0, depth - 1)[:, None]
    for key, val in (("st_node", far), ("st_tmin", t_plane), ("st_tmax", tmax)):
        st = s[key]
        st.scatter_(1, slot_push, torch.where(push, val, st.gather(1, slot_push)[:, 0])[:, None])

    cur_next = torch.where(descend, torch.where(go_far, far, near),
                           torch.where(can_pop, popped_node, -1))
    s["cur"] = torch.where(retire, -1, cur_next)
    s["tmin"] = torch.where(can_pop & ~descend, popped_tmin, tmin)
    s["tmax"] = torch.where(descend, torch.where(push, t_plane, tmax),
                            torch.where(can_pop, popped_tmax, tmax))
    s["sp"] = torch.where(descend, torch.where(push, sp + 1, sp), sp_pop)
    s["best_t"], s["best_id"] = best_t, best_id


def walk(step, s: dict, max_iters: int, check_every: int) -> int:
    """Run ``step(s)`` until no lane walks (``s["cur"] >= 0`` nowhere) or
    ``max_iters`` steps have run, reading the stop test on the host every
    ``check_every`` steps (the steps in between are no-ops on finished
    lanes). Returns the number of steps run."""
    it = 0
    while it < max_iters and bool((s["cur"] >= 0).any()):
        k = min(check_every, max_iters - it)
        for _ in range(k):
            step(s)
        it += k
    return it


def _traverse(rays: Rays, bsp: BspBuffers, vertices, indices):
    """The walk over every lane; returns (t, prim id or -1, converged)."""
    n = rays.o.shape[0]
    dev = rays.o.device
    depth = bsp.max_level + 1
    tmin0, tmax0, box_hit = _aabb_clamp(rays, bsp.bbox_lo, bsp.bbox_hi)
    s = dict(
        cur=torch.where(box_hit, 0, -1).to(torch.int64),
        sp=torch.zeros(n, dtype=torch.int64, device=dev),
        st_node=torch.zeros((n, depth), dtype=torch.int64, device=dev),
        st_tmin=torch.zeros((n, depth), dtype=torch.float32, device=dev),
        st_tmax=torch.zeros((n, depth), dtype=torch.float32, device=dev),
        tmin=tmin0, tmax=tmax0, best_t=rays.tmax,
        best_id=torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    walk(lambda st: _step(rays, bsp, vertices, indices, st), s, MAX_ITERS, 1)
    return s["best_t"], s["best_id"].to(torch.int32), s["cur"] < 0


@torch.no_grad()
def bsp_closest_hit(rays: Rays, bsp: BspBuffers, vertices, indices, with_conv: bool = False):
    """First-leaf-hit walk (``intersect_trimesh``): (t, prim id or -1), and
    with ``with_conv`` a per-lane bool, False where ``MAX_ITERS`` cut the
    walk (the reference hangs the GPU there; this flags it)."""
    t, pid, conv = _traverse(rays, bsp, vertices, indices)
    return (t, pid, conv) if with_conv else (t, pid)


@torch.no_grad()
def bsp_any_hit(rays: Rays, bsp: BspBuffers, vertices, indices, with_conv: bool = False):
    """Occlusion walk (``intersect_trimesh_immediate_return``): blocked,
    and with ``with_conv`` the converged flags."""
    _, pid, conv = _traverse(rays, bsp, vertices, indices)
    return (pid >= 0, conv) if with_conv else pid >= 0

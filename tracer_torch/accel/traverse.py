"""The per-ray binary BVH walk, ``traversal="bvh2"`` (port of
``tracer.accel.traverse``), in PyTorch ops.

The reference walks its BVH with a private node stack per GPU thread
(``reference/res/shaders/bvh.wgsl:127-191``). Here every lane of the
wavefront advances in lockstep over an (N, ``STACK_DEPTH``) stack: each
step reads the lane's node, tests its box, and tests a leaf's triangles
(at most ``max_leaf`` slots, as in the JAX package), descends to the nearer
child or pops. A lane still walking after ``MAX_ITERS`` steps (the
reference's cap, ``bvh.wgsl:164``) keeps what it found so far, as in the
JAX package, which flags nothing here. A finished lane's step changes
nothing, so the host reads "is any lane still walking" only every
``CHECK_EVERY`` steps.

The walk carries no gradient: it returns integer ids (and t), from which
the integrator re-derives every hit attribute.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from tracer_torch.accel.bsp import as_tensor, walk
from tracer_torch.accel.lbvh import BvhBuffers
from tracer_torch.kernels.intersect import INF, Rays, triangle_t

STACK_DEPTH = 64  # radix-trie depth bound for 64-bit keys
MAX_ITERS = 1000  # safety bound, mirroring bvh.wgsl:164
# Steps between host reads of the stop test: each read is a device sync,
# and the walks take a few dozen to a few hundred steps, so at most 15 idle
# steps (no-ops on finished lanes) are paid against a sync per step.
CHECK_EVERY = 16


def to_device(bvh, device) -> BvhBuffers:
    """The BVH's arrays as tensors on ``device`` (``bsp.as_tensor``). Reads
    any object with the fields of ``BvhBuffers`` whose arrays are NumPy
    arrays (the JAX package's too)."""
    return BvhBuffers(**{f.name: as_tensor(getattr(bvh, f.name), device)
                         for f in fields(BvhBuffers)})


def _leaf_hit(rays: Rays, best_t, vertices, indices, prim_ids, first, count, max_leaf: int):
    """Up to ``max_leaf`` triangles of each lane's leaf, slot by slot, each
    lane its own; returns (t, prim id or -1) of the nearest hit below
    ``best_t``."""
    t_best = best_t
    id_best = torch.full(best_t.shape, -1, dtype=torch.int64, device=best_t.device)
    last = prim_ids.shape[0] - 1
    for k in range(max_leaf):
        slot_ok = k < count
        pid = prim_ids[(first + k).clamp(0, last)]
        tri = indices[pid].long()
        t, _, _, ok = triangle_t(Rays(rays.o, rays.d, rays.tmin, t_best),
                                 vertices[tri[:, 0]], vertices[tri[:, 1]], vertices[tri[:, 2]])
        ok = ok & slot_ok
        id_best = torch.where(ok & (t < t_best), pid, id_best)
        t_best = torch.where(ok, torch.minimum(t, t_best), t_best)
    return t_best, id_best


def _box(bvh: BvhBuffers, node, o, inv_d):
    """(near, far) of the slab test of each lane's ray against ``node``."""
    t0 = (bvh.node_min[node] - o) * inv_d
    t1 = (bvh.node_max[node] - o) * inv_d
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


def _push(s: dict, push, val) -> None:
    """Push ``val`` on the lanes of ``push`` (a row scatter)."""
    slot = s["sp"].clamp(0, STACK_DEPTH - 1)[:, None]
    st = s["stack"]
    st.scatter_(1, slot, torch.where(push, val, st.gather(1, slot)[:, 0])[:, None])
    s["sp"] = torch.where(push, s["sp"] + 1, s["sp"])


def _pop(s: dict, can_pop):
    s["sp"] = torch.where(can_pop, s["sp"] - 1, s["sp"])
    return s["stack"].gather(1, s["sp"].clamp(0, STACK_DEPTH - 1)[:, None])[:, 0]


def _closest_step(rays, bvh, vertices, indices, max_leaf, inv_d, s):
    cur = s["cur"]
    active = cur >= 0
    node = cur.clamp(0, bvh.left.shape[0] - 1)
    near, far = _box(bvh, node, rays.o, inv_d)
    box_hit = active & (near <= far) & (far >= rays.tmin) & (near <= s["best_t"])
    count = bvh.count[node]
    is_leaf = count > 0
    do_leaf = box_hit & is_leaf
    lt, lid = _leaf_hit(rays, torch.where(do_leaf, s["best_t"], -INF), vertices, indices,
                        bvh.prim_ids, bvh.first[node], torch.where(do_leaf, count, 0), max_leaf)
    got = do_leaf & (lid >= 0)
    s["best_id"] = torch.where(got, lid, s["best_id"])
    s["best_t"] = torch.where(got, lt, s["best_t"])

    # Descend to the child whose box the ray enters first; push the other.
    descend = box_hit & ~is_leaf
    lchild, rchild = bvh.left[node], bvh.right[node]
    l_near, _ = _box(bvh, lchild, rays.o, inv_d)
    r_near, _ = _box(bvh, rchild, rays.o, inv_d)
    left_first = l_near <= r_near
    _push(s, descend & (s["sp"] < STACK_DEPTH), torch.where(left_first, rchild, lchild))
    can_pop = active & ~descend & (s["sp"] > 0)
    popped = _pop(s, can_pop)
    s["cur"] = torch.where(descend, torch.where(left_first, lchild, rchild),
                           torch.where(can_pop, popped, -1))


def _anyhit_step(rays, bvh, vertices, indices, max_leaf, inv_d, s):
    cur = s["cur"]
    active = cur >= 0
    node = cur.clamp(0, bvh.left.shape[0] - 1)
    near, far = _box(bvh, node, rays.o, inv_d)
    box_hit = active & (near <= far) & (far >= rays.tmin) & (near <= rays.tmax)
    count = bvh.count[node]
    is_leaf = count > 0
    do_leaf = box_hit & is_leaf
    _, lid = _leaf_hit(rays, torch.where(do_leaf, rays.tmax, -INF), vertices, indices,
                       bvh.prim_ids, bvh.first[node], torch.where(do_leaf, count, 0), max_leaf)
    s["blocked"] = s["blocked"] | (do_leaf & (lid >= 0))
    # A blocked lane retires at once.
    descend = box_hit & ~is_leaf & ~s["blocked"]
    lchild, rchild = bvh.left[node], bvh.right[node]
    _push(s, descend & (s["sp"] < STACK_DEPTH), rchild)
    can_pop = active & ~descend & ~s["blocked"] & (s["sp"] > 0)
    popped = _pop(s, can_pop)
    s["cur"] = torch.where(descend, lchild, torch.where(can_pop, popped, -1))


def _state(rays: Rays, **extra) -> dict:
    n, dev = rays.o.shape[0], rays.o.device
    return dict(cur=torch.zeros(n, dtype=torch.int64, device=dev),
                sp=torch.zeros(n, dtype=torch.int64, device=dev),
                stack=torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev), **extra)


@torch.no_grad()
def bvh_closest_hit(rays: Rays, bvh: BvhBuffers, vertices, indices, max_leaf: int = 8):
    """Closest hit: (t, prim id or -1)."""
    inv_d = 1.0 / rays.d
    s = _state(rays, best_t=rays.tmax,
               best_id=torch.full(rays.tmax.shape, -1, dtype=torch.int64, device=rays.o.device))
    walk(lambda st: _closest_step(rays, bvh, vertices, indices, max_leaf, inv_d, st), s,
         MAX_ITERS, CHECK_EVERY)
    return s["best_t"], s["best_id"].to(torch.int32)


@torch.no_grad()
def bvh_any_hit(rays: Rays, bvh: BvhBuffers, vertices, indices, max_leaf: int = 8):
    """Occlusion (``intersect_trimesh_immediate_return``, ``bsp.wgsl:83``):
    True where a triangle blocks [tmin, tmax]; a lane retires at its first
    blocker."""
    inv_d = 1.0 / rays.d
    s = _state(rays, blocked=torch.zeros(rays.tmax.shape, dtype=torch.bool,
                                         device=rays.o.device))
    walk(lambda st: _anyhit_step(rays, bvh, vertices, indices, max_leaf, inv_d, st), s,
         MAX_ITERS, CHECK_EVERY)
    return s["blocked"]

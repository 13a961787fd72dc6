"""Treelet-cut BVH (port of ``tracer.accel.treelet``).

The binary LBVH is cut into maximal subtrees of at most ``T`` triangles
(treelets). Each treelet packs its triangles into one feature-major block,
and the flat engine streams quarter blocks of ``T / NQ`` Morton-adjacent
triangles through the super-tile hits kernel. Block rows:

  row 0:3   v0            row 9     prim id (exact float, ids < 2^24)
  row 3:6   e0 = v1 - v0  row 10    valid (1.0 / 0.0)
  row 6:9   e1 = v2 - v0  row 11:14 geometric normal n = cross(e0, e1)
                          row 14    k = dot(v0, n)   row 15 pad

``build_host`` (cut selection + 8-ary top-tree collapse) is NumPy and
bit-identical to the JAX package's; ``assemble_blocks`` gathers the block
table on the device in PyTorch. The flat engine reads the quarter blocks,
the quarter boxes and the treelet boxes; the packet engine walks the top
tree and streams whole blocks, and block ``b`` is the four contiguous
quarters ``qblocks[b*NQ:(b+1)*NQ]``, so ``TreeletBvh`` keeps one table for
both. The JAX package's matmul-form (MXU) table has no counterpart here.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from tracer_torch.accel.lbvh import BvhBuffers

_INF = np.float32(3.0e38)
NQ = 4  # quarter-blocks per block: Möller gating granularity (T/NQ tris)
ROWS = 16  # feature rows per block


@dataclass(frozen=True)
class TreeletBvh:
    qblocks: torch.Tensor  # (NT*NQ, 16, T/NQ) f32, contiguous quarter blocks
    qbox: torch.Tensor  # (NT, NQ, 6) f32 quarter-block AABBs [lo3, hi3]
    t_lo: torch.Tensor  # (NT, 3) f32 treelet root AABB lo
    t_hi: torch.Tensor  # (NT, 3) f32 treelet root AABB hi
    top: torch.Tensor  # (R, 8, 8) f32 top tree: [lo3, hi3, ref (i32 bits), pad]
    T: int  # triangles per block
    depth: int  # max top-tree descent depth (the packet walk's stack bound)

    @property
    def NT(self) -> int:
        return int(self.qbox.shape[0])


@dataclass(frozen=True)
class TreeletHost:
    """Host product of the treelet build: everything but the block table,
    which ``assemble_blocks`` gathers on the device from ``pids``."""

    top: np.ndarray  # (R, 8, 8) f32
    pids: np.ndarray  # (NT, T) i32 primitive id per block slot
    counts: np.ndarray  # (NT,) i32 valid slots per block
    t_lo: np.ndarray  # (NT, 3) f32
    t_hi: np.ndarray  # (NT, 3) f32
    box_table: np.ndarray  # (NT, 8) f32
    depth: int
    T: int


def assemble_blocks(verts: torch.Tensor, idx: torch.Tensor,
                    pids: torch.Tensor, valid: torch.Tensor):
    """Gather + edge/normal precompute for the quarter-block table and the
    quarter-block AABBs on the device. verts (V, 3) f32, idx (N, 3) i32,
    pids (NT, T) i32, valid (NT, T) bool -> (qblocks (NT*NQ, 16, T/NQ),
    qbox (NT, NQ, 6))."""
    NT, T = pids.shape
    TQ = T // NQ
    tri = idx.long()[pids.long()]  # (NT, T, 3)
    v = verts[tri]  # (NT, T, 3, 3)
    v0 = v[:, :, 0]
    e0 = v[:, :, 1] - v0
    e1 = v[:, :, 2] - v0
    nrm = torch.stack(
        [
            e0[..., 1] * e1[..., 2] - e0[..., 2] * e1[..., 1],
            e0[..., 2] * e1[..., 0] - e0[..., 0] * e1[..., 2],
            e0[..., 0] * e1[..., 1] - e0[..., 1] * e1[..., 0],
        ],
        dim=-1,
    )
    p = v0 * nrm
    kpl = p[..., 0] + p[..., 1] + p[..., 2]
    pidf = torch.where(valid, pids, -1).to(torch.float32)
    rows = [
        v0[..., 0], v0[..., 1], v0[..., 2],
        e0[..., 0], e0[..., 1], e0[..., 2],
        e1[..., 0], e1[..., 1], e1[..., 2],
        pidf,
        valid.to(torch.float32),
        nrm[..., 0], nrm[..., 1], nrm[..., 2],
        kpl,
        torch.zeros_like(kpl),  # row 15: padding
    ]
    blocks = torch.stack(rows, dim=1)  # (NT, 16, T)
    # Contiguous quarter view: quarter q of block b is row b*NQ + q, so one
    # emission is one contiguous 16*TQ*4-byte chunk for the kernel to stage.
    qblocks = (
        blocks.reshape(NT, ROWS, NQ, TQ).permute(0, 2, 1, 3)
        .reshape(NT * NQ, ROWS, TQ).contiguous()
    )
    vq = v.reshape(NT, NQ, TQ, 3, 3)
    vmask = valid.reshape(NT, NQ, TQ, 1, 1)
    qlo = torch.where(vmask, vq, 3e38).amin(dim=(2, 3))
    qhi = torch.where(vmask, vq, -3e38).amax(dim=(2, 3))
    # Empty quarters (partial blocks) collapse to a far point box, NOT the
    # +/-3e38 sentinels: those overflow the interval slab products to inf
    # and an inverted-infinite box passes the gate, gating every sub-tile
    # against every partial block.
    empty = ~valid.reshape(NT, NQ, TQ).any(dim=-1)  # (NT, NQ)
    qlo = torch.where(empty[..., None], 1.0e30, qlo)
    qhi = torch.where(empty[..., None], 1.0e30, qhi)
    return qblocks, torch.cat([qlo, qhi], dim=-1)


def from_host(host: TreeletHost, verts: torch.Tensor,
              idx: torch.Tensor) -> TreeletBvh:
    """TreeletHost + device geometry -> TreeletBvh (blocks gathered on the
    geometry's device)."""
    device = verts.device
    T = host.T
    pids = torch.as_tensor(host.pids, dtype=torch.int32, device=device)
    counts = torch.as_tensor(host.counts, dtype=torch.int32, device=device)
    valid = torch.arange(T, dtype=torch.int32, device=device)[None, :] < counts[:, None]
    qblocks, qbox = assemble_blocks(verts, idx, pids, valid)
    return TreeletBvh(
        qblocks=qblocks,
        qbox=qbox,
        t_lo=torch.as_tensor(host.t_lo, dtype=torch.float32, device=device),
        t_hi=torch.as_tensor(host.t_hi, dtype=torch.float32, device=device),
        top=torch.as_tensor(host.top, dtype=torch.float32, device=device),
        T=T,
        depth=int(host.depth),
    )


def _subtree_prims(bvh: BvhBuffers):
    """Contiguous sorted-prim range (first, count) of every node — Karras
    ranges are contiguous, so any subtree is a slice of prim_ids
    (port of ``tracer.accel.wide._subtree_prims``)."""
    first = bvh.first.astype(np.int64).copy()
    count = bvh.count.astype(np.int64).copy()
    internal = bvh.count == 0
    il = bvh.left[internal].astype(np.int64)
    ir = bvh.right[internal].astype(np.int64)
    ii = np.nonzero(internal)[0]
    for _ in range(64):
        nf = np.minimum(first[il], first[ir])
        nc = count[il] + count[ir]
        if np.array_equal(nf, first[ii]) and np.array_equal(nc, count[ii]):
            break
        first[ii] = nf
        count[ii] = nc
    return first, count


def build_host(bvh: BvhBuffers, T: int = 1024) -> TreeletHost:
    """Host half of the treelet build: cut selection + top-tree collapse.

    Fully vectorized (the subtree ranges of a Karras radix tree are
    contiguous in sorted-primitive order, so every treelet is a slice of
    ``prim_ids``); the top-tree collapse is a small host loop over ~NT/7
    rows.
    """
    prim_ids = bvh.prim_ids.astype(np.int64)
    n = bvh.left.shape[0]
    count = bvh.count
    left = bvh.left.astype(np.int64)
    right = bvh.right.astype(np.int64)
    sub_first, sub_count = _subtree_prims(bvh)
    # A leaf with count > T would not be "small": the collapse below would
    # try to expand it through left/right == -1. The LBVH always splits
    # down to max_prims <= 4 << T, so this is a build invariant.
    if int(count.max(initial=0)) > T:
        raise ValueError(
            f"LBVH leaf with {int(count.max())} prims exceeds treelet size {T}"
        )

    # --- Treelet cut: maximal subtrees with <= T primitives.
    internal = count == 0
    parent = np.full(n, -1, np.int64)
    ii = np.nonzero(internal)[0]
    parent[left[ii]] = ii
    parent[right[ii]] = ii
    small = sub_count <= T
    parent_small = np.zeros(n, bool)
    has_p = parent >= 0
    parent_small[has_p] = small[parent[has_p]]
    is_cut = small & ~parent_small
    cut_nodes = np.nonzero(is_cut)[0]
    order = np.argsort(sub_first[cut_nodes], kind="stable")
    cut_nodes = cut_nodes[order]  # DFS (sorted-prim) order
    NT = cut_nodes.shape[0]
    firsts = sub_first[cut_nodes].astype(np.int64)
    counts = sub_count[cut_nodes].astype(np.int64)
    tid_of = np.full(n, -1, np.int64)
    tid_of[cut_nodes] = np.arange(NT)

    # --- Block slot -> primitive id matrix (the only per-triangle work).
    slot = np.arange(T)
    mat = firsts[:, None] + slot[None, :]  # (NT, T) indices into prim_ids
    valid = slot[None, :] < counts[:, None]
    pids = np.where(valid, prim_ids[np.clip(mat, 0, prim_ids.shape[0] - 1)], 0)

    # --- Top tree: 8-ary collapse of everything above the cut.
    rows_box: list[np.ndarray] = []
    rows_ref: list[np.ndarray] = []
    max_depth = 1

    if is_cut[0]:
        # Whole mesh fits one treelet: a single row pointing at it.
        box = np.full((8, 6), 0.0, np.float32)
        box[:, 0:3] = _INF
        box[:, 3:6] = -_INF
        box[0, 0:3] = bvh.node_min[0]
        box[0, 3:6] = bvh.node_max[0]
        refs = np.full(8, -1, np.int32)
        refs[0] = -2
        rows_box.append(box)
        rows_ref.append(refs)
    else:
        pending: deque = deque()
        pending.append((0, 1))  # (binary node, depth); row id == pop order
        next_row = 1
        while pending:
            node, dep = pending.popleft()
            max_depth = max(max_depth, dep)
            slots = [int(node)]
            while len(slots) < 8:
                cand = [s for s in slots if not is_cut[s]]
                if not cand:
                    break
                s = max(cand, key=lambda x: sub_count[x])
                slots.remove(s)
                slots.extend((int(left[s]), int(right[s])))
            box = np.zeros((8, 6), np.float32)
            box[:, 0:3] = _INF
            box[:, 3:6] = -_INF
            refs = np.full(8, -1, np.int32)
            for ci, s in enumerate(slots):
                box[ci, 0:3] = bvh.node_min[s]
                box[ci, 3:6] = bvh.node_max[s]
                if is_cut[s]:
                    refs[ci] = np.int32(-2 - tid_of[s])
                else:
                    refs[ci] = next_row
                    pending.append((s, dep + 1))
                    next_row += 1
            rows_box.append(box)
            rows_ref.append(refs)

    R = len(rows_box)
    top = np.zeros((R, 8, 8), np.float32)
    top[:, :, 0:6] = np.stack(rows_box)
    top[:, :, 6] = np.stack(rows_ref).view(np.float32)
    box_table = np.zeros((NT, 8), np.float32)
    box_table[:, 0:3] = bvh.node_min[cut_nodes]
    box_table[:, 3:6] = bvh.node_max[cut_nodes]
    return TreeletHost(
        top=top,
        pids=pids.astype(np.int32),
        counts=counts.astype(np.int32),
        t_lo=np.asarray(bvh.node_min[cut_nodes], np.float32),
        t_hi=np.asarray(bvh.node_max[cut_nodes], np.float32),
        box_table=box_table,
        depth=int(max_depth),
        T=T,
    )


def build(bvh: BvhBuffers, vertices: torch.Tensor, indices: torch.Tensor,
          T: int = 1024) -> TreeletBvh:
    """Cut the binary LBVH into <=T-triangle treelets and gather the block
    table on the device of ``vertices``/``indices``."""
    return from_host(build_host(bvh, T), vertices, indices)


def validate(tb: TreeletBvh, num_prims: int) -> None:
    """Builder invariant: every primitive id appears exactly once across
    the valid block slots."""
    pid = tb.qblocks[:, 9, :].cpu().numpy().astype(np.int64)
    valid = tb.qblocks[:, 10, :].cpu().numpy() > 0.5
    covered = np.zeros(num_prims, np.int64)
    np.add.at(covered, pid[valid], 1)
    if not (covered == 1).all():
        raise AssertionError("every primitive must be in exactly one treelet")

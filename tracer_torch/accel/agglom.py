"""Naive agglomerative BVH (port of ``tracer.accel.agglom``): the
reference's validation-only builder, NumPy only.

The semantics of ``reference/src/data_structures/bvh.rs:68-164``: greedy
closest-center pair merging (O(n^2) per merge in the reference's scan;
here a vectorized NumPy distance matrix), followed by ``collapse``, which
turns every subtree holding <= max_prims primitives into a leaf over a
contiguous primitive range.

Like the reference, this exists to validate the production builder: it
emits the ``BvhBuffers`` layout of ``tracer_torch.accel.lbvh``, so the
same walks (``tracer_torch.accel.traverse``) and validators run against
it. Only use on small meshes (the pair scan is quadratic).
"""

from __future__ import annotations

import numpy as np

from tracer_torch.accel.lbvh import BvhBuffers


def build(prim_lo: np.ndarray, prim_hi: np.ndarray, max_prims: int = 4
          ) -> BvhBuffers:
    n = prim_lo.shape[0]
    assert n >= 1
    lo = np.asarray(prim_lo, np.float64)
    hi = np.asarray(prim_hi, np.float64)

    # Cluster state: python forest of (bbox_lo, bbox_hi, node) where node is
    # either ('leaf', prim) or ('int', left, right).
    clusters = [
        (lo[i].copy(), hi[i].copy(), ("leaf", i)) for i in range(n)
    ]
    while len(clusters) > 1:
        centers = np.array([(c[0] + c[1]) * 0.5 for c in clusters])
        d2 = np.sum(
            (centers[:, None, :] - centers[None, :, :]) ** 2, axis=-1
        )
        np.fill_diagonal(d2, np.inf)
        i, j = np.unravel_index(np.argmin(d2), d2.shape)
        a = clusters[i]
        b = clusters[j]
        merged = (
            np.minimum(a[0], b[0]),
            np.maximum(a[1], b[1]),
            ("int", a[2], b[2]),
        )
        for k in sorted((int(i), int(j)), reverse=True):
            clusters.pop(k)
        clusters.append(merged)

    root_lo, root_hi, root = clusters[0]

    # Collapse + flatten to the BvhBuffers SoA: leaf-ordered prim ids with
    # per-node (first, count); internal nodes carry child links.
    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    left: list[int] = []
    right: list[int] = []
    first: list[int] = []
    count: list[int] = []
    prim_ids: list[int] = []

    def prims_of(node) -> list[int]:
        if node[0] == "leaf":
            return [node[1]]
        return prims_of(node[1]) + prims_of(node[2])

    def bbox_of(node):
        ps = prims_of(node)
        return lo[ps].min(axis=0), hi[ps].max(axis=0)

    def emit(node) -> int:
        idx = len(node_min)
        blo, bhi = bbox_of(node)
        node_min.append(blo)
        node_max.append(bhi)
        left.append(-1)
        right.append(-1)
        first.append(0)
        count.append(0)
        ps = prims_of(node)
        if node[0] == "leaf" or len(ps) <= max_prims:
            first[idx] = len(prim_ids)
            count[idx] = len(ps)
            prim_ids.extend(ps)
        else:
            left[idx] = emit(node[1])
            right[idx] = emit(node[2])
        return idx

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 100))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old)

    return BvhBuffers(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        first=np.asarray(first, np.int32),
        count=np.asarray(count, np.int32),
        prim_ids=np.asarray(prim_ids, np.int32),
    )

"""The work of one call of kernel B1 (``kernels.super_hits.hits2``), frozen.

``live_tests`` is the counting of ``hits2_reference``'s ``stats`` in
``tracer_torch/kernels/super_hits.py`` as of commit 571a042, with its
Möller tile (``moller_tile``) to carry each sub-tile's bound through the
stream, since which lanes are live at a block depends on the hits before
it: the Möller tests of live lanes (tmin below the lane's best t before
the block) in every (sub-tile, quarter block) visit the gate words and
bounds allow. ``least_ms`` is ``chip_smoke.b1_bound``: every input read
once (the quarter blocks that a live slot with a gate bit names), the
output written once, 38 float32 operations per live test
(``csrc/moller.cuh``: 3 dot products of 5, 6 products and 3 differences
for the cross product, 3 differences, a division, a subtraction and 3
products for t, beta and gamma, a negation and a sum for the inside
test), over the card's peaks.
"""

from __future__ import annotations

import torch

from benchmark.counts import peaks

SUB, NSUB = 128, 16
INF = 3.0e38
OPS_PER_TEST = 38
CHUNK = 512


def _moller_tile(blk, rays, upper):
    c = lambda j: blk[:, None, j, :]
    rx = lambda j: rays[:, :, j, None]
    ox, oy, oz = rx(0), rx(1), rx(2)
    dx, dy, dz = rx(3), rx(4), rx(5)
    tn = rx(6)
    nx, ny, nz = c(11), c(12), c(13)
    inv = (nx * dx + ny * dy + nz * dz).reciprocal()
    t = (c(14) - (nx * ox + ny * oy + nz * oz)) * inv
    sx, sy, sz = c(0) - ox, c(1) - oy, c(2) - oz
    nomx = sy * dz - sz * dy
    nomy = sz * dx - sx * dz
    nomz = sx * dy - sy * dx
    beta = (nomx * c(6) + nomy * c(7) + nomz * c(8)) * inv
    gamma = -(nomx * c(3) + nomy * c(4) + nomz * c(5)) * inv
    ok = (beta >= 0.0) & (gamma >= 0.0) & ((beta + gamma) <= 1.0) & (t >= tn) \
        & (t < upper[..., None]) & (c(10) > 0.5)
    tc = torch.where(ok, t, INF)
    tbest = tc.amin(dim=-1, keepdim=True)
    pidw = torch.where(tc <= tbest, c(9), INF)
    pbest = pidw.amin(dim=-1, keepdim=True)
    pbest = torch.where(tbest < INF, pbest, -1.0)
    return tbest[..., 0], pbest[..., 0]


def live_tests(qblocks, eids, enear, en, gatemask, o, d, tmin, best_t, best_pid,
               any_hit: bool) -> int:
    """The Möller tests of live lanes in one call's visits."""
    n_super, KD = eids.shape
    NTQ, _, TQ = qblocks.shape
    dev = o.device
    bt = best_t.to(torch.float32).reshape(n_super, NSUB, SUB).clone()
    bp = best_pid.to(torch.float32).reshape(n_super, NSUB, SUB).clone()
    if any_hit:
        bt = torch.where(bp > 0.0, -INF, bt)
    rays = torch.cat([o, d, tmin[..., None]], dim=-1).reshape(n_super, NSUB, SUB, 7)
    ids = eids.long().clamp(0, NTQ - 1)
    bits = torch.bitwise_left_shift(torch.ones(NSUB, dtype=torch.int64, device=dev),
                                    torch.arange(NSUB, dtype=torch.int64, device=dev))
    gated = (gatemask.long()[:, :, None] & bits) != 0
    ub = bt.amax(dim=-1)
    gub = torch.full((n_super,), INF, dtype=torch.float32, device=dev)
    live = torch.ones(n_super, dtype=torch.bool, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(KD):
        ek = enear[:, k]
        live = live & (k < en) & (ek < gub)
        if not bool(live.any()):
            break
        run = live[:, None] & gated[:, k] & (ek[:, None] < ub)
        sup_i, sub_i = torch.nonzero(run, as_tuple=True)
        for a in range(0, sup_i.shape[0], CHUNK):
            si, s = sup_i[a:a + CHUNK], sub_i[a:a + CHUNK]
            upper = bt[si, s]
            tests += (rays[si, s, :, 6] < upper).sum() * TQ
            t, pid = _moller_tile(qblocks[ids[si, k]], rays[si, s], upper)
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
    return int(tests)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def least_ms(qblocks, eids, enear, en, gatemask, o, d, tmin, best_t, best_pid,
             any_hit: bool) -> float:
    """The least milliseconds of one call on the card's peaks."""
    tests = live_tests(qblocks, eids, enear, en, gatemask, o, d, tmin, best_t, best_pid,
                       any_hit)
    TQ = qblocks.shape[2]
    live = (torch.arange(eids.shape[1], device=eids.device) < en[:, None]) & (gatemask != 0)
    blocks = eids.long().clamp(0, qblocks.shape[0] - 1)[live].unique().numel() * 16 * TQ * 4
    n_bytes = blocks + _nbytes(eids, enear, en, gatemask, o, d, tmin, best_t, best_pid) \
        + _nbytes(best_t, best_pid)
    return peaks.least_ms(n_bytes, tests * OPS_PER_TEST)[0]

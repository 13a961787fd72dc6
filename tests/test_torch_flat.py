"""The port's flat frustum engine against the JAX package's, on the same
treelet buffers (a ~1.1k-triangle blob cut into 32-triangle treelets, so
frames span many blocks and a small K overflows).

Tolerance: hit ids must be equal except on at most 0.5% of lanes; each
disputed lane must be genuinely borderline: every claimed triangle is
re-tested and its barycentrics must lie within 1e-4 of the valid region,
and where both sides claim a hit their t must agree to 1e-4 relative (the
disputed triangles share an edge, so a real disagreement would show as a
far-apart depth). On lanes whose ids agree, t agrees to rtol 1e-5: both
sides evaluate the same float32 formula, but XLA on the CPU contracts
multiply-adds into FMAs and t = (k - n.o) / (n.d) cancels. Any-hit flags,
converged flags and the seeded-vs-unseeded comparison within the port are
exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from tracer.accel import flat as jax_flat
from tracer.accel import lbvh as jax_lbvh
from tracer.accel import treelet as jax_treelet
from tracer.geometry.procedural import bumpy_blob
from tracer.kernels.intersect import make_rays as jax_make_rays

from tracer_torch import convert
from tracer_torch.accel import flat
from tracer_torch.kernels import intersect
from tracer_torch.kernels.intersect import make_rays

share_cores()

W, H = 41, 29  # deliberately unaligned with the 64x32 super-tiles


@pytest.fixture(scope="module")
def blob():
    mesh = bumpy_blob(24, 24, 1.0, (0.0, 0.0, 0.0))
    binary = jax_lbvh.build(*mesh.bboxes(), max_prims=4)
    jtb = jax_treelet.build(binary, mesh.vertices, mesh.indices, T=32)
    ptb = convert.treelet_from_arrays(jax.tree.map(np.asarray, jtb), "cpu")
    return mesh, jtb, ptb


def _frame_rays(origin=(0.1, 0.0, 3.0)):
    u = (np.arange(W) + 0.5) / W - 0.5
    v = 0.5 - (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    d = np.stack([uu.ravel(), vv.ravel(), -np.ones(W * H)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.array([origin], np.float32), (W * H, 1))
    return o, d


def _mixed_rays(n=1024, seed=0):
    """Half coherent (shared-origin pinhole cone), half incoherent."""
    rs = np.random.RandomState(seed)
    o1 = np.tile(np.array([[3.0, 0.2, 0.1]], np.float32), (n // 2, 1))
    d1 = rs.randn(n // 2, 3).astype(np.float32) * 0.4 - o1
    o2 = rs.randn(n // 2, 3).astype(np.float32) * 3.0
    d2 = rs.randn(n // 2, 3).astype(np.float32)
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _both(o, d, **kw):
    return (jax_make_rays(jnp.asarray(o), jnp.asarray(d), **kw),
            make_rays(torch.as_tensor(o), torch.as_tensor(d), **kw))


def _assert_hits_agree(mesh, o, d, jt, jid, pt, pid):
    jt, jid = np.asarray(jt), np.asarray(jid)
    pt, pid = pt.numpy(), pid.numpy()
    same = jid == pid
    assert (~same).mean() <= 0.005, f"{(~same).sum()} of {same.size} ids differ"
    hit = same & (pid >= 0)
    assert hit.sum() > 100
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-5)
    assert np.array_equal(pt[same & (pid < 0)], jt[same & (pid < 0)])
    V = torch.as_tensor(mesh.vertices)
    I = mesh.indices.astype(np.int64)
    for lane in np.nonzero(~same)[0]:
        for claimed in (jid[lane], pid[lane]):
            if claimed < 0:
                continue
            tri = I[claimed]
            ray = make_rays(torch.as_tensor(o[lane:lane + 1]),
                            torch.as_tensor(d[lane:lane + 1]))
            _, b, g, _ = intersect.triangle_t(ray, V[tri[0]], V[tri[1]], V[tri[2]])
            b, g = float(b[0]), float(g[0])
            assert b >= -1e-4 and g >= -1e-4 and b + g <= 1 + 1e-4, (lane, claimed, b, g)
        if jid[lane] >= 0 and pid[lane] >= 0:
            assert abs(pt[lane] - jt[lane]) <= 1e-4 * abs(jt[lane]), lane


def test_super_tiling_matches_jax():
    x = np.random.RandomState(0).randn(W * H, 3).astype(np.float32)
    a = np.asarray(jax_flat.to_supers(jnp.asarray(x), W, H, fill=7.0))
    b = flat.to_supers(torch.as_tensor(x), W, H, 7.0)
    assert np.array_equal(a, b.numpy())
    assert torch.equal(flat.from_supers(b, W, H), torch.as_tensor(x))


def test_closest_frame_matches_jax(blob):
    mesh, jtb, ptb = blob
    o, d = _frame_rays()
    jr, pr = _both(o, d)
    jt, jid = jax_flat.closest_hit(jr, jtb, frame=(W, H))
    pt, pid, conv = flat.closest_hit(pr, ptb, frame=(W, H), with_conv=True)
    assert bool(conv.all())
    _assert_hits_agree(mesh, o, d, jt, jid, pt, pid)


def test_closest_frame_matches_jax_pallas_interpret(blob, monkeypatch):
    """The JAX engine through its Pallas kernel (interpret mode) rather
    than its XLA fallback: the same gate/skip/break semantics as the twin."""
    monkeypatch.setenv("TRACER_FORCE_PALLAS", "1")
    mesh, jtb, ptb = blob
    o, d = _frame_rays(origin=(-0.2, 0.3, 2.5))
    jr, pr = _both(o, d)
    jt, jid = jax_flat.closest_hit(jr, jtb, frame=(W, H))
    pt, pid = flat.closest_hit(pr, ptb, frame=(W, H))
    _assert_hits_agree(mesh, o, d, jt, jid, pt, pid)


def test_overflow_rounds_match_jax(blob):
    """K=8 emissions per super-tile: overflowing super-tiles sweep the
    remaining quarter blocks in id-order rounds."""
    mesh, jtb, ptb = blob
    o, d = _mixed_rays(512, seed=3)
    jr, pr = _both(o, d)
    jt, jp, jconv = jax_flat._run(jr, jtb, None, any_hit=False, K=8)
    em = flat.emissions(pr, ptb, None, K=8)
    assert bool(em.overflow.any())
    pt, pp, pconv = flat._run(pr, ptb, None, any_hit=False, K=8)
    assert bool(pconv.all()) and bool(np.asarray(jconv).all())
    jid = np.asarray(jp).astype(np.int32)
    _assert_hits_agree(mesh, o, d, jt, jid, pt, pp.to(torch.int32))


def test_seeded_frame_with_repair_matches_jax(blob):
    """A seed far too tight sends every hit lane through the repair pass;
    the result equals the JAX engine's and the port's own unseeded one."""
    mesh, jtb, ptb = blob
    o, d = _frame_rays()
    jr, pr = _both(o, d)
    t0, id0 = flat.closest_hit(pr, ptb, frame=(W, H))
    seed = np.where(id0.numpy() >= 0, t0.numpy(), 0.0).astype(np.float32) * 0.05
    jt, jid = jax_flat.closest_hit(jr, jtb, frame=(W, H), seed_t=jnp.asarray(seed))
    pt, pid = flat.closest_hit(pr, ptb, frame=(W, H), seed_t=torch.as_tensor(seed))
    _assert_hits_agree(mesh, o, d, jt, jid, pt, pid)
    assert torch.equal(pid, id0) and torch.equal(pt, t0)
    good = torch.where(id0 >= 0, t0, 0.0)
    pt2, pid2 = flat.closest_hit(pr, ptb, frame=(W, H), seed_t=good)
    assert torch.equal(pid2, id0) and torch.equal(pt2, t0)


def test_any_hit_matches_jax(blob):
    _, jtb, ptb = blob
    o, d = _mixed_rays(1024, seed=5)
    jr, pr = _both(o, d, tmax=4.0)
    jb = np.asarray(jax_flat.any_hit(jr, jtb))
    pb, conv = flat.any_hit(pr, ptb, with_conv=True)
    assert bool(conv.all())
    assert jb.sum() > 100 and np.array_equal(jb, pb.numpy())


def test_truncation_is_flagged_like_jax(blob, monkeypatch):
    """A sweep cut off by the round cap clears ``converged`` on exactly
    the lanes where the JAX engine clears it."""
    _, jtb, ptb = blob
    o, d = _mixed_rays(512, seed=3)
    jr, pr = _both(o, d)
    monkeypatch.setattr(jax_flat, "MAX_ROUNDS", 1)
    monkeypatch.setattr(flat, "MAX_ROUNDS", 1)
    _, _, jconv = jax_flat._run(jr, jtb, None, any_hit=False, K=2)
    _, _, pconv = flat._run(pr, ptb, None, any_hit=False, K=2)
    assert not bool(pconv.all())
    assert np.array_equal(np.asarray(jconv), pconv.numpy())

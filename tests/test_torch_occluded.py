"""The flat engine's any-hit query (``tracer_torch.kernels.super_occluded``)
against the JAX package's, on the CPU.

Inputs: ``chip_smoke.OCCLUSION_CASES``, a bumpy blob cut into treelets of
32, 256 or 1024 triangles (quarters of 8, 64 and 256) and rays from numpy
with a seed (a pinhole frame, mixed coherent and incoherent rays with dead
windows, parallel shadow rays towards a directional light, rays that graze
quarter-box faces, edges and corners through mesh vertices), at K = 96
(no overflow), 8, 4 and 2 (overflowing super-tiles sweep every quarter in
id order) and round caps of 4096, 2 and 1 (the sweep cut short). The JAX
side builds the treelets; the port gets the same tables through
``convert.treelet_from_arrays``. The CUDA kernel is held against the twin
route on the card in ``tests/test_torch_cuda.py``.

Tolerance: none. The blocked flags, the best t row and the converged flags
must be equal bit for bit: both sides test the same quarter blocks with
the same Möller formula and a lane's flag is an OR over them (XLA's FMA
contraction moves t by a few ulp at most, which decides a flag only for a
hit exactly at a window's edge; none of these rays has one). The grazing
rays are aimed where rounding decides, so against JAX their flags are
held bitwise on the lanes that a float64 re-test does not dispute, and
every lane that differs must be disputed. The kernel's sweep gate
(``sweep_gates``, its plain version) must be open on every (sub-tile,
quarter) pair where the twin's Möller test finds a hit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from chip_smoke import OCCLUSION_CASES, occlusion_case, occlusion_rays
from tracer.accel import flat as jax_flat
from tracer.accel import lbvh as jax_lbvh
from tracer.accel import treelet as jax_treelet
from tracer.geometry.procedural import bumpy_blob
from tracer.kernels.intersect import make_rays as jax_make_rays

from tracer_torch import convert
from tracer_torch.accel import flat
from tracer_torch.kernels import super_hits, super_occluded
from tracer_torch.kernels.intersect import make_rays

share_cores()

# The grazing rays aim at vertices and slide along axis planes through them,
# so a share of their flags turns on float32 rounding, where XLA's FMA
# contraction and the twin's separate roundings may differ: they are held
# to the JAX package on the lanes that are not disputed.
JAX_CASES = [name for name, case in OCCLUSION_CASES.items()
             if not case[6] and case[2] != "graze"]
GRAZE_CASES = [name for name, case in OCCLUSION_CASES.items() if case[2] == "graze"]
# A lane is disputed when no triangle holds it inside the Möller test's
# acceptance region by more than this margin and some triangle lies within
# it. Margins are in barycentric units (the window's ends relative to
# max(1, |t|)) times the cosine between the ray and the triangle's normal:
# float32's barycentrics and t lose precision as 1 / cos near grazing.
EPS_DISPUTED = 1e-4


@pytest.fixture(scope="module")
def blobs():
    """(mesh, JAX treelets, the port's copy) per (subdivisions, T)."""
    out = {}
    for n_sub, T in sorted({case[:2] for case in OCCLUSION_CASES.values()}):
        mesh = bumpy_blob(n_sub, n_sub, 1.0, (0.0, 0.0, 0.0))
        jtb = jax_treelet.build(jax_lbvh.build(*mesh.bboxes(), max_prims=4),
                                mesh.vertices, mesh.indices, T=T)
        out[n_sub, T] = (mesh, jtb,
                         convert.treelet_from_arrays(jax.tree.map(np.asarray, jtb), "cpu"))
    return out


@pytest.mark.parametrize("name", JAX_CASES)
def test_twin_route_matches_jax(blobs, name, monkeypatch):
    """``flat._run(any_hit=True)`` on the CPU (``occluded`` takes the twin
    route for CPU tensors) against ``tracer.accel.flat._run``: flags, t and
    converged bitwise, with the case's K and round cap on both sides."""
    n_sub, T, kind, seed, K, max_rounds, _ = OCCLUSION_CASES[name]
    mesh, jtb, ptb = blobs[n_sub, T]
    o, d, tmin, tmax, frame = occlusion_rays(kind, seed, mesh)
    monkeypatch.setattr(jax_flat, "MAX_ROUNDS", max_rounds)
    monkeypatch.setattr(flat, "MAX_ROUNDS", max_rounds)
    jr = jax_make_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    pr = make_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmin),
                   torch.as_tensor(tmax))
    jt, jp, jconv = (np.asarray(x) for x in jax_flat._run(jr, jtb, frame, any_hit=True, K=K))
    calls, launches = super_occluded.REFERENCE_CALLS, super_occluded.KERNEL_LAUNCHES
    pt, pp, pconv = flat._run(pr, ptb, frame, any_hit=True, K=K)
    assert super_occluded.REFERENCE_CALLS == calls + 1
    assert super_occluded.KERNEL_LAUNCHES == launches
    assert np.array_equal(pp.numpy().view(np.int32), jp.view(np.int32))
    assert np.array_equal(pt.numpy().view(np.int32), jt.view(np.int32))
    assert np.array_equal(pconv.numpy(), jconv)
    live = tmin < tmax
    assert 0 < int((pp.numpy() > 0).sum()) < int(live.sum())
    em = flat.emissions(pr, ptb, frame, any_hit=True, K=K)
    assert bool(em.overflow.any()) == (K < ptb.NT)
    assert bool(pconv.all()) == (super_occluded.sweep_length(
        ptb.qblocks.shape[0], em.ids.shape[1], max_rounds) >= ptb.qblocks.shape[0]
        or not bool(em.overflow.any()))


def _disputed(o, d, tmin, tmax, mesh, chunk=256):
    """(N,) bool: lanes whose blocked flag can turn on float32 rounding
    (``EPS_DISPUTED``), from float64 barycentrics and t of every triangle;
    and (N,) bool: lanes blocked by some triangle with a margin above it."""
    V = np.asarray(mesh.vertices, np.float64)
    v0, v1, v2 = (V[mesh.indices[:, k]][None] for k in range(3))
    e0, e1 = v1 - v0, v2 - v0
    n = np.cross(e0, e1)
    disputed, blocked = [], []
    for a in range(0, o.shape[0], chunk):
        oc, dc = o[a:a + chunk].astype(np.float64), d[a:a + chunk].astype(np.float64)
        ov = v0 - oc[:, None]
        nom = np.cross(ov, dc[:, None])
        with np.errstate(divide="ignore", invalid="ignore"):
            dn = (dc[:, None] * n).sum(-1)
            beta = (nom * e1).sum(-1) / dn
            gamma = -(nom * e0).sum(-1) / dn
            t = (ov * n).sum(-1) / dn
            sc = np.maximum(np.abs(t), 1.0)
            cos = np.abs(dn) / (np.linalg.norm(n, axis=-1) * np.linalg.norm(dc, axis=-1)[:, None])
            m = cos * np.minimum.reduce([beta, gamma, 1.0 - beta - gamma,
                                         (t - tmin[a:a + chunk, None]) / sc,
                                         (tmax[a:a + chunk, None] - t) / sc])
        m = np.where(np.isnan(m), -np.inf, m)
        inside = (m > EPS_DISPUTED).any(axis=1)
        disputed.append(~inside & (np.abs(m) <= EPS_DISPUTED).any(axis=1))
        blocked.append(inside)
    return np.concatenate(disputed), np.concatenate(blocked)


@pytest.mark.parametrize("name", GRAZE_CASES)
def test_twin_route_matches_jax_on_grazing_rays(blobs, name, monkeypatch):
    """The grazing cases through ``flat._run(any_hit=True)`` on both sides:
    t and converged bitwise; the flags equal on every lane that is not
    disputed, and there equal to float64's answer; every lane whose flag
    differs is disputed."""
    n_sub, T, kind, seed, K, max_rounds, _ = OCCLUSION_CASES[name]
    mesh, jtb, ptb = blobs[n_sub, T]
    o, d, tmin, tmax, frame = occlusion_rays(kind, seed, mesh)
    monkeypatch.setattr(jax_flat, "MAX_ROUNDS", max_rounds)
    monkeypatch.setattr(flat, "MAX_ROUNDS", max_rounds)
    jr = jax_make_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    pr = make_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmin),
                   torch.as_tensor(tmax))
    jt, jp, jconv = (np.asarray(x) for x in jax_flat._run(jr, jtb, frame, any_hit=True, K=K))
    pt, pp, pconv = flat._run(pr, ptb, frame, any_hit=True, K=K)
    pp = pp.numpy()
    assert np.array_equal(pt.numpy().view(np.int32), jt.view(np.int32))
    assert np.array_equal(pconv.numpy(), jconv) and bool(pconv.all())
    disputed, blocked = _disputed(o, d, tmin, tmax, mesh)
    assert 0 < disputed.sum() < 0.5 * o.shape[0]
    assert np.array_equal(pp[~disputed] > 0, blocked[~disputed])
    assert np.array_equal(pp[~disputed], jp[~disputed])
    assert disputed[pp != jp].all()


def test_any_hit_at_k96_matches_jax(blobs):
    """The default K through ``flat.any_hit`` on the incoherent rays: the
    blocked mask equals the JAX package's ``any_hit``."""
    mesh, jtb, ptb = blobs[24, 32]
    o, d, tmin, tmax, _ = occlusion_rays("mixed", 7, mesh)
    jr = jax_make_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    pr = make_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmin),
                   torch.as_tensor(tmax))
    jb = np.asarray(jax_flat.any_hit(jr, jtb))
    pb, conv = flat.any_hit(pr, ptb, with_conv=True)
    assert bool(conv.all()) and jb.sum() > 100
    assert np.array_equal(jb, pb.numpy())


def test_truncated_any_hit_is_flagged_like_jax(blobs, monkeypatch):
    """MAX_ROUNDS = 1 at K = 2: no sweep round runs, and ``converged`` is
    cleared on exactly the lanes where the JAX engine clears it."""
    mesh, jtb, ptb = blobs[24, 32]
    o, d, tmin, tmax, _ = occlusion_rays("mixed", 3, mesh)
    jr = jax_make_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    pr = make_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmin),
                   torch.as_tensor(tmax))
    monkeypatch.setattr(jax_flat, "MAX_ROUNDS", 1)
    monkeypatch.setattr(flat, "MAX_ROUNDS", 1)
    _, jp, jconv = jax_flat._run(jr, jtb, None, any_hit=True, K=2)
    _, pp, pconv = flat._run(pr, ptb, None, any_hit=True, K=2)
    assert not bool(pconv.all())
    assert np.array_equal(np.asarray(jconv), pconv.numpy())
    assert np.array_equal(np.asarray(jp), pp.numpy())


@pytest.mark.parametrize("max_rounds", [0, 1, 2, 3, 31, 32, 4096])
def test_converged_formula_equals_the_rounds(max_rounds):
    """The kernel's converged flag (``converged``: the sweep's length
    against the quarter count) equals what the twin route's rounds give,
    at caps below, at and above the 31 rounds that sweep all 248 quarters
    at K = 2 (8 slots a round)."""
    tb, em, _ = occlusion_case("mixed K=2 cap 1", "cpu")
    assert bool(em.overflow.all())
    _, _, conv = super_occluded.occluded_reference(tb, em, max_rounds)
    assert torch.equal(conv, super_occluded.converged(tb, em, max_rounds))
    assert bool(conv.all()) == (max_rounds >= 32)


def test_the_wrapper_takes_the_twin_on_the_cpu_and_refuses_other_devices():
    tb, em, max_rounds = occlusion_case("mixed K=8 pre-blocked", "cpu")
    calls, launches = super_occluded.REFERENCE_CALLS, super_occluded.KERNEL_LAUNCHES
    got = super_occluded.occluded(tb, em, max_rounds)
    want = super_occluded.occluded_reference(tb, em, max_rounds)
    assert super_occluded.REFERENCE_CALLS == calls + 2
    assert super_occluded.KERNEL_LAUNCHES == launches
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # Pre-blocked lanes keep their flag; the others are -1 or newly 1.
    pre = em.bp0 > 0
    assert bool((got[1][pre] == 1.0).all()) and bool(((got[1] == 1.0) | (got[1] == -1.0)).all())
    assert torch.equal(got[0], em.bt0)
    meta = dataclasses.replace(em, o=em.o.to("meta"))
    with pytest.raises(RuntimeError):
        super_occluded.occluded(tb, meta, max_rounds)
    assert super_occluded.KERNEL_LAUNCHES == launches


def test_the_twin_route_with_stats_counts_the_list_and_the_rounds():
    """``stats`` adds up over the culled list's call and each sweep round:
    equal to the counts of the same calls made one by one."""
    tb, em, max_rounds = occlusion_case("mixed K=8", "cpu")
    st = {}
    super_occluded.occluded_reference(tb, em, max_rounds, stats=st)
    want = {}
    args = (em.o, em.d, em.tmin)
    bt, bp = super_hits.hits2_reference(tb, em.ids, em.enear, em.en, em.gm, *args, em.bt0,
                                        em.bp0, True, stats=want)
    hits = lambda *a: super_hits.hits2_reference(*a, stats=want)
    super_hits.sweep(hits, tb, em.ids.shape[1], em.overflow, *args, bt, bp, True, max_rounds)
    for key in ("visits", "staged", "rounds", "live_tests"):
        assert st[key] == want[key] > 0, key


@pytest.mark.parametrize("name", list(OCCLUSION_CASES))
def test_work_items_cover_the_list_and_the_sweep(name):
    """The kernel's work items (``work_items``): the items with a nonzero
    key are exactly the (super-tile, sub-tile, chunk) triples with a gated
    list slot below ``en`` or, for an overflowing super-tile and a live
    sub-tile, sweep quarters below the cap; every sweep item comes before
    every list item, and the keys fall."""
    tb, em, max_rounds = occlusion_case(name, "cpu")
    n_super, kd = em.ids.shape
    n_sweep = super_occluded.sweep_length(tb.qblocks.shape[0], kd, max_rounds)
    order, key, ncl, nch = super_occluded.work_items(em, n_sweep)
    C = super_occluded.CHUNK
    assert order.shape == key.shape == (n_super * 16 * nch,)
    assert bool((key[:-1] >= key[1:]).all())
    want = set()
    gm, en = em.gm.tolist(), em.en.tolist()
    alive = (em.sb[:, :, 13] > 0.5).tolist()
    for u in range(n_super):
        for s in range(16):
            for k in range(min(en[u], kd)):
                if (gm[u][k] >> s) & 1:
                    want.add((u * 16 + s) * nch + k // C)
            if bool(em.overflow[u]) and alive[u][s]:
                want.update((u * 16 + s) * nch + ncl + q // C for q in range(n_sweep))
    got = order[key > 0].tolist()
    assert len(got) == len(set(got)) and set(got) == want
    chunks = [i % nch for i in got]
    first_list = next((j for j, c in enumerate(chunks) if c < ncl), len(chunks))
    assert all(c < ncl for c in chunks[first_list:])


def _hit_pairs(tb, em):
    """(n_super, NSUB, n_quarters) bool: some lane of the sub-tile with an
    open window hits a triangle of the quarter in it (``moller_tile``, the
    twin's test), i.e. the pairs on which the ungated sweep finds a hit."""
    n_sub = em.n_super * super_hits.NSUB
    rays = torch.cat([em.o, em.d, em.tmin[..., None]], dim=-1).reshape(n_sub, super_hits.SUB, 7)
    upper = em.bt0.reshape(n_sub, super_hits.SUB)
    live = rays[..., 6] < upper
    out = torch.stack([
        ((super_hits.moller_tile(blk[None].expand(n_sub, -1, -1), rays, upper)[1] >= 0.0)
         & live).any(dim=-1) for blk in tb.qblocks], dim=-1)
    return out.reshape(em.n_super, super_hits.NSUB, -1)


@pytest.mark.parametrize("name", list(OCCLUSION_CASES))
def test_sweep_gates_without_margin_are_the_culled_lists_gates(name, monkeypatch):
    """``sweep_gates`` with no margin equals ``_gate_words(_sub_gates_raw)``
    over every treelet, for every (super-tile, quarter) pair; the margin
    only opens gates."""
    tb, em, _ = occlusion_case(name, "cpu")
    ids = torch.arange(tb.NT, dtype=torch.int64).expand(em.n_super, -1)
    ok, _ = flat._sub_gates_raw(tb, ids, em.sb, em.prune_sub)  # (ns, NT, NSUB, NQ)
    words = flat._gate_words(ok)  # (ns, NT * NQ)
    gates = super_occluded.sweep_gates(tb, em)
    monkeypatch.setattr(super_occluded, "GATE_PAD", 0.0)
    raw = super_occluded.sweep_gates(tb, em)
    bits = torch.arange(16, dtype=torch.int32)
    assert torch.equal(((words[:, None, :] >> bits[None, :, None]) & 1).bool(), raw)
    assert bool((gates | ~raw).all())


@pytest.mark.parametrize("name", list(OCCLUSION_CASES))
def test_sweep_gates_are_open_wherever_a_lane_hits(name, monkeypatch):
    """The kernel may skip a sweep quarter for a sub-tile only where the
    ungated twin finds no hit there: every (sub-tile, quarter) pair with a
    Möller hit of one of its lanes has its gate open. On the grazing rays
    the gate without its margin fails this (the reason for the margin)."""
    tb, em, _ = occlusion_case(name, "cpu")
    hits = _hit_pairs(tb, em)
    assert bool(hits.any())
    assert not bool((hits & ~super_occluded.sweep_gates(tb, em)).any())
    if name == "graze K=2":
        monkeypatch.setattr(super_occluded, "GATE_PAD", 0.0)
        assert bool((hits & ~super_occluded.sweep_gates(tb, em)).any())

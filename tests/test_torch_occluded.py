"""The flat engine's any-hit query (``tracer_torch.kernels.super_occluded``)
against the JAX package's, on the CPU.

Inputs: ``chip_smoke.OCCLUSION_CASES``, a bumpy blob cut into treelets of
32, 256 or 1024 triangles (quarters of 8, 64 and 256) and rays from numpy
with a seed (a pinhole frame, mixed coherent and incoherent rays with dead
windows, parallel shadow rays towards a directional light, rays that graze
quarter-box faces, edges and corners through mesh vertices), at K = 96
(no overflow), 8, 4 and 2 (overflowing super-tiles sweep every quarter in
id order) and round caps of 4096, 2 and 1 (the sweep cut short), and rays
almost in the plane of a triangle (cos 2^-16, 2^-20, 2^-24 to its normal)
aimed just outside its quarter's box. The JAX side builds the treelets;
the port gets the same tables through ``convert.treelet_from_arrays``. The
CUDA kernel is held against the twin route on the card in
``tests/test_torch_cuda.py``.

Tolerance: none. The blocked flags, the best t row and the converged flags
must be equal bit for bit: both sides test the same quarter blocks with
the same Möller formula and a lane's flag is an OR over them (XLA's FMA
contraction moves t by a few ulp at most, which decides a flag only for a
hit exactly at a window's edge; none of these rays has one). The grazing
and near-coplanar rays are aimed where rounding decides, so against JAX
their flags are held bitwise on the lanes that a float64 re-test does not
dispute, and every lane that differs must be disputed. XLA's CPU backend
contracts a * b + c into one FMA, the port never does: a model of the JAX
side's Möller test with those contractions gives JAX's flag on most of the
lanes that differ. The kernel's sweep gate (``sweep_gates``, its plain
version) must be open on every (sub-tile, quarter) pair where the twin's
Möller test finds a hit, a model of the kernel's flags (the culled list,
then the sweep through those gates) must equal the twin route's on every
lane, and every point that a float32 Möller test accepts must lie within
the written bound of ``csrc/super_occluded.cu`` of its quarter's box.
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
# the coplanar rays run almost in a triangle's plane, so a share of their
# flags turns on float32 rounding, where XLA's FMA contraction and the
# twin's separate roundings may differ: they are held to the JAX package on
# the lanes that are not disputed.
ROUNDING_KINDS = ("graze", "coplanar")
JAX_CASES = [name for name, case in OCCLUSION_CASES.items()
             if not case[6] and case[2].split()[0] not in ROUNDING_KINDS]
GRAZE_CASES = [name for name, case in OCCLUSION_CASES.items()
               if case[2].split()[0] in ROUNDING_KINDS]
COPLANAR_CASES = [name for name, case in OCCLUSION_CASES.items()
                  if case[2].startswith("coplanar")]
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
    o, d, tmin, tmax, frame = occlusion_rays(kind, seed, mesh, T)
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


def _fma_flags(blocks, o, d, tmin, tmax):
    """(N,) bool: some valid triangle of ``blocks`` (16, n) accepts the
    ray in its window under ``_moller_tile`` of the JAX package as XLA's
    CPU backend compiles it, each a * b + rest one FMA (a * b + c * d as
    fma(a, b, c * d)), modelled in float64 and rounded to float32."""
    f = np.float32
    fma = lambda a, b, c: (a.astype(np.float64) * b + c).astype(f)
    c = lambda j: blocks[j][None, :]
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*o.T, *d.T))
    dot = lambda x0, y0, x1, y1, x2, y2: fma(x2, y2, fma(x0, y0, x1 * y1))
    inv = f(1.0) / dot(c(11), dx, c(12), dy, c(13), dz)
    t = (c(14) - dot(c(11), ox, c(12), oy, c(13), oz)) * inv
    sx, sy, sz = c(0) - ox, c(1) - oy, c(2) - oz
    nomx, nomy, nomz = fma(sy, dz, -(sz * dy)), fma(sz, dx, -(sx * dz)), fma(sx, dy, -(sy * dx))
    beta = dot(nomx, c(6), nomy, c(7), nomz, c(8)) * inv
    gamma = -dot(nomx, c(3), nomy, c(4), nomz, c(5)) * inv
    ok = ((beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= tmin[:, None])
          & (t < tmax[:, None]) & (c(10) > 0.5))
    return ok.any(axis=1)


@pytest.mark.parametrize("name", GRAZE_CASES)
def test_twin_route_matches_jax_on_grazing_rays(blobs, name, monkeypatch):
    """The grazing and coplanar cases through ``flat._run(any_hit=True)``
    on both sides: t and converged bitwise; the flags equal on every lane
    that is not disputed, and there equal to float64's answer; every lane
    whose flag differs is disputed, and on at least three in four of them
    the FMA model of the JAX side (``_fma_flags``, every quarter tested:
    the sweep of these cases reaches all) gives JAX's flag."""
    n_sub, T, kind, seed, K, max_rounds, _ = OCCLUSION_CASES[name]
    mesh, jtb, ptb = blobs[n_sub, T]
    o, d, tmin, tmax, frame = occlusion_rays(kind, seed, mesh, T)
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
    lanes = np.nonzero(pp != jp)[0]
    assert lanes.size > 0
    fma = _fma_flags(np.concatenate(list(ptb.qblocks.numpy()), axis=1),
                     o[lanes], d[lanes], tmin[lanes], tmax[lanes])
    assert 4 * int((fma == (jp[lanes] > 0)).sum()) >= 3 * lanes.size


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
    # The gate check runs only the kernel's device function: no CPU path.
    with pytest.raises(RuntimeError):
        super_occluded.kernel_sweep_gates(tb, em)
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
    """``sweep_gates`` with no margin (``GATE_PAD = COND_PAD = 0``) equals
    ``_gate_words(_sub_gates_raw)`` over every treelet, for every
    (super-tile, quarter) pair; the margins only open gates."""
    tb, em, _ = occlusion_case(name, "cpu")
    ids = torch.arange(tb.NT, dtype=torch.int64).expand(em.n_super, -1)
    ok, _ = flat._sub_gates_raw(tb, ids, em.sb, em.prune_sub)  # (ns, NT, NSUB, NQ)
    words = flat._gate_words(ok)  # (ns, NT * NQ)
    gates = super_occluded.sweep_gates(tb, em)
    monkeypatch.setattr(super_occluded, "COND_PAD", 0.0)
    padded = super_occluded.sweep_gates(tb, em)
    monkeypatch.setattr(super_occluded, "GATE_PAD", 0.0)
    raw = super_occluded.sweep_gates(tb, em)
    bits = torch.arange(16, dtype=torch.int32)
    assert torch.equal(((words[:, None, :] >> bits[None, :, None]) & 1).bool(), raw)
    assert bool((padded | ~raw).all()) and bool((gates | ~padded).all())


@pytest.mark.parametrize("name", list(OCCLUSION_CASES))
def test_sweep_gates_are_open_wherever_a_lane_hits(name, monkeypatch):
    """The kernel may skip a sweep quarter for a sub-tile only where the
    ungated twin finds no hit there: every (sub-tile, quarter) pair with a
    Möller hit of one of its lanes has its gate open. On the grazing rays
    the gate without its margins fails this, and on the coplanar rays the
    gate without its second term (``COND_PAD = 0``: the box grown by 2^-16
    of the coordinates only)."""
    tb, em, _ = occlusion_case(name, "cpu")
    hits = _hit_pairs(tb, em)
    assert bool(hits.any())
    assert not bool((hits & ~super_occluded.sweep_gates(tb, em)).any())
    if name in COPLANAR_CASES:
        monkeypatch.setattr(super_occluded, "COND_PAD", 0.0)
        assert bool((hits & ~super_occluded.sweep_gates(tb, em)).any())
    if name == "graze K=2":
        monkeypatch.setattr(super_occluded, "COND_PAD", 0.0)
        monkeypatch.setattr(super_occluded, "GATE_PAD", 0.0)
        assert bool((hits & ~super_occluded.sweep_gates(tb, em)).any())


def _model_flags(tb, em, max_rounds):
    """The kernel's blocked flags, modelled on the CPU: the twin's B1 over
    the culled list (its gate words and skip rule), then for overflowing
    super-tiles every quarter of the sweep's length that ``sweep_gates``
    lets through, each lane tested with the twin's Möller test. A flag is
    an OR over the blocks, so the order of the tests does not matter."""
    args = (em.o, em.d, em.tmin)
    _, flags = super_hits.hits2_reference(tb, em.ids, em.enear, em.en, em.gm, *args, em.bt0,
                                          em.bp0, True)
    n_sub = em.n_super * super_hits.NSUB
    n_sweep = super_occluded.sweep_length(tb.qblocks.shape[0], em.ids.shape[1], max_rounds)
    gates = (super_occluded.sweep_gates(tb, em).reshape(n_sub, -1)
             & em.overflow.repeat_interleave(super_hits.NSUB)[:, None])
    rays = torch.cat([em.o, em.d, em.tmin[..., None]], dim=-1).reshape(n_sub, super_hits.SUB, 7)
    upper = em.bt0.reshape(n_sub, super_hits.SUB)
    live = rays[..., 6] < upper
    hit = torch.zeros_like(live)
    for q in range(n_sweep):
        pid = super_hits.moller_tile(tb.qblocks[q][None].expand(n_sub, -1, -1), rays, upper)[1]
        hit |= (pid >= 0.0) & live & gates[:, q, None]
    return torch.where(hit.reshape(flags.shape), 1.0, flags)


@pytest.mark.parametrize("name", list(OCCLUSION_CASES))
def test_kernel_model_flags_equal_the_twin_routes(name):
    """The kernel's flags as ``_model_flags`` models them equal the twin
    route's (``occluded_reference``, an ungated sweep) on every lane."""
    tb, em, max_rounds = occlusion_case(name, "cpu")
    want = super_occluded.occluded_reference(tb, em, max_rounds)[1]
    got = _model_flags(tb, em, max_rounds)
    assert int((want > 0).sum()) > int((em.bp0 > 0).sum())
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", COPLANAR_CASES)
def test_kernel_model_without_the_conditioning_term_loses_coplanar_lanes(name, monkeypatch):
    """With ``COND_PAD = 0`` (no second term) the modelled kernel finds
    lanes unblocked that the twin route blocks (and never the other way
    round): the coplanar miss the second term repairs."""
    tb, em, max_rounds = occlusion_case(name, "cpu")
    want = super_occluded.occluded_reference(tb, em, max_rounds)[1]
    monkeypatch.setattr(super_occluded, "COND_PAD", 0.0)
    got = _model_flags(tb, em, max_rounds)
    assert bool(((want > 0) & ~(got > 0)).any())
    assert not bool(((got > 0) & ~(want > 0)).any())


@pytest.mark.parametrize("name", GRAZE_CASES)
def test_accepted_points_lie_within_the_written_bound(name):
    """Every (lane, triangle) pair that the twin's float32 Möller test
    accepts puts its point o + t d (in float64) within the written bound
    of its quarter's box: on each axis at most COND_PAD * G * cond / cos
    outside it, with cond the triangle's |e0| |e1| / |n|, cos its
    |n . d| / (|n| |d|) and G = A + W + M / 8 of the gate with the lane's
    own origin for the sub-tile's origin box. On the coplanar rays some
    accepted points lie outside the box grown by the fixed margin alone
    (2^-16 of the coordinates)."""
    tb, em, _ = occlusion_case(name, "cpu")
    o = em.o.reshape(-1, 3)
    d = em.d.reshape(-1, 3)
    rays = torch.cat([o, d, em.tmin.reshape(-1, 1)], dim=-1)
    upper = em.bt0.reshape(-1)
    live = rays[:, 6] < upper
    boxes = tb.qbox.reshape(-1, 6).double()
    worst, beyond_pad, n_acc = 0.0, 0, 0
    for q, blk in enumerate(tb.qblocks):
        cols = blk.t()[:, :, None]  # (TQ, 16, 1): one triangle a block
        t, pid = super_hits.moller_tile(cols, rays[None].expand(cols.shape[0], -1, -1),
                                        upper[None].expand(cols.shape[0], -1))
        acc = (pid >= 0.0) & live[None]  # (TQ, N)
        if not bool(acc.any()):
            continue
        c, lane = acc.nonzero(as_tuple=True)
        od, dd = o[lane].double(), d[lane].double()
        p = od + t[c, lane].double()[:, None] * dd
        lo, hi = boxes[q, :3], boxes[q, 3:]
        out = torch.maximum(lo - p, p - hi).clamp_min(0.0)  # (n, 3)
        tri = blk.double()[:, c]  # (16, n)
        e0, e1, n = tri[3:6], tri[6:9], tri[11:14]
        cond = e0.norm(dim=0) * e1.norm(dim=0) / n.norm(dim=0)
        cos = (dd * n.t()).sum(-1).abs() / (n.norm(dim=0) * dd.norm(dim=-1))
        mag = (lo.abs() + hi.abs()) + 2.0 * od.abs()
        g = (torch.maximum(hi - od, od - lo).sum(-1) + (hi - lo).sum()
             + 0.125 * (torch.maximum(lo.abs(), hi.abs()) + od.abs()).sum(-1))
        bound = super_occluded.COND_PAD * g * cond / cos
        worst = max(worst, float((out.amax(-1) / bound).max()))
        beyond_pad += int((out > super_occluded.GATE_PAD * mag).any(-1).sum())
        n_acc += int(lane.numel())
    assert n_acc > 1000
    assert worst <= 1.0
    if name in COPLANAR_CASES:
        assert beyond_pad > 0


@pytest.mark.parametrize("name", ["mixed K=2 cap 2", "coplanar 2^-20 K=2"])
def test_open_share_counts_the_swept_pairs(name):
    """``open_share``: the open gates among the (sub-tile, quarter) pairs
    the sweep reaches, counted pair by pair; the cap cuts the sweep to one
    round of KD quarters."""
    tb, em, max_rounds = occlusion_case(name, "cpu")
    gates = super_occluded.sweep_gates(tb, em)
    n_sweep = super_occluded.sweep_length(tb.qblocks.shape[0], em.ids.shape[1], max_rounds)
    want_open = want_all = 0
    for u in range(em.n_super):
        for s in range(16):
            if bool(em.overflow[u]) and float(em.sb[u, s, 13]) > 0.5:
                want_all += n_sweep
                want_open += int(gates[u, s, :n_sweep].sum())
    assert super_occluded.open_share(tb, em, gates, max_rounds) == (want_open, want_all)
    assert 0 < want_open < want_all
    assert (n_sweep < tb.qblocks.shape[0]) == (max_rounds == 2)


def test_quarter_normals_bound_every_valid_triangle():
    """``treelet.quarter_normals`` on a blob's quarters of 8 and 256
    triangles (the last treelet partly empty): the box holds every valid
    triangle's unit normal and cond is at least each one's |e0| |e1| / |n|
    (both within an ulp or two: rounded outward); quarters with no valid
    triangle get cond 0."""
    from tracer_torch.accel import treelet

    for n_sub, T in ((24, 32), (64, 1024)):
        tb, _, _ = occlusion_case(next(k for k, c in OCCLUSION_CASES.items()
                                       if c[:2] == (n_sub, T)), "cpu")
        qn = tb.qnorm.reshape(-1, 8)
        q = tb.qblocks.double()
        valid = q[:, 10] > 0.5
        n = q[:, 11:14]
        nn = n.norm(dim=1)
        unit = n / nn.clamp_min(1e-300)[:, None]
        cond = q[:, 3:6].norm(dim=1) * q[:, 6:9].norm(dim=1) / nn.clamp_min(1e-300)
        lo, hi = qn[:, 0:3, None].double(), qn[:, 3:6, None].double()
        assert bool(((unit >= lo) & (unit <= hi) | ~valid[:, None]).all())
        assert bool(((cond <= qn[:, 6, None].double()) | ~valid).all())
        assert torch.equal(qn[:, 6] > 0, valid.any(dim=1))
        assert float((hi - lo).max()) <= 2.0 + 1e-6 and bool((qn[:, 7] == 0).all())
        assert torch.equal(tb.qnorm, treelet.quarter_normals(tb.qblocks))

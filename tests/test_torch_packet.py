"""The packet engine (path mode's mesh traversal) against the JAX package's
packet engine with its XLA phase B, and against brute force, on the same
treelet buffers (a 1,152-triangle procedural blob cut into treelets of 32,
as ``tests/test_accel.py`` builds it).

Cases: a mixed wavefront (half a coherent pinhole cone, half random rays),
its occlusion query over a [tmin, 4] window, an unaligned frame-shaped
wavefront (41x29, padded to 8x16 tiles), and ``K_EMIT`` lowered to 16 to
force pause-and-resume rounds.

Tolerance: phase A uses exactly rounded operations only, so both packages
emit the same blocks; phase B differs by FMA contraction (XLA on the CPU
fuses multiply-adds, the port rounds each operation), and the brute-force
reference is the JAX package's matmul form, which associates differently.
So hit ids must be equal except on a few grazing lanes (at most 0.5%), and
every disputed claim is re-tested in float64: each claimed triangle must be
within 1e-4 of its barycentric bounds, and the t claimed with it must be
that triangle's t to 1e-4 relative (where one side grazes a silhouette
edge that the other misses, the two t's belong to different surfaces and
may be far apart). On agreeing lanes t agrees to 1e-5 relative.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from tracer.accel import lbvh as jax_lbvh
from tracer.accel import packet as jax_packet
from tracer.accel import treelet as jax_treelet
from tracer.geometry.procedural import bumpy_blob
from tracer.kernels.intersect import make_rays as jax_make_rays
from tracer.kernels.intersect import mesh_brute_force, mesh_brute_force_anyhit

from tracer_torch import convert
from tracer_torch import obs
from tracer_torch.accel import packet
from tracer_torch.kernels import phase_a_walk
from tracer_torch.kernels.intersect import make_rays

share_cores()


@pytest.fixture(scope="module")
def blob():
    mesh = bumpy_blob(24, 24, 1.0, (0.0, 0.0, 0.0))
    binary = jax_lbvh.build(*mesh.bboxes(), max_prims=4)
    jtb = jax_treelet.build(binary, mesh.vertices, mesh.indices, T=32)
    tb = convert.treelet_from_arrays(jax.tree.map(np.asarray, jtb), "cpu")
    return mesh, jtb, tb


def _mixed(n=1024, seed=0):
    """Half coherent (shared-origin pinhole cone), half incoherent."""
    rs = np.random.RandomState(seed)
    o1 = np.tile(np.array([[3.0, 0.2, 0.1]], np.float32), (n // 2, 1))
    d1 = rs.randn(n // 2, 3).astype(np.float32) * 0.4 - o1
    o2 = rs.randn(n // 2, 3).astype(np.float32) * 3.0
    d2 = rs.randn(n // 2, 3).astype(np.float32)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _frame(W=41, H=29):
    u = (np.arange(W) + 0.5) / W - 0.5
    v = 0.5 - (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    d = np.stack([uu.ravel(), vv.ravel(), -np.ones(W * H)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.tile(np.array([[0.1, 0.0, 3.0]], np.float32), (W * H, 1)), d


def _barycentric(mesh, tri, o, d):
    """(t, beta, gamma) of one ray against one triangle, in float64."""
    v0, v1, v2 = (mesh.vertices[mesh.indices[tri, c]].astype(np.float64) for c in range(3))
    o, d = o.astype(np.float64), d.astype(np.float64)
    e0, e1 = v1 - v0, v2 - v0
    n = np.cross(e0, e1)
    nom = np.cross(v0 - o, d)
    den = d @ n
    return (v0 - o) @ n / den, nom @ e1 / den, -(nom @ e0) / den


def _assert_agree(mesh, o, d, ids, t, ref_ids, ref_t):
    """Ids equal but on a few borderline lanes; t checked everywhere."""
    dis = ids != ref_ids
    assert dis.mean() <= 0.005, f"{dis.sum()} of {dis.size} ids differ"
    for lane in np.nonzero(dis)[0]:
        for claimed, tc in ((ids[lane], t[lane]), (ref_ids[lane], ref_t[lane])):
            if claimed >= 0:
                t64, b, g = _barycentric(mesh, claimed, o[lane], d[lane])
                assert b >= -1e-4 and g >= -1e-4 and b + g <= 1 + 1e-4, (lane, claimed, b, g)
                assert abs(tc - t64) <= 1e-4 * abs(t64), (lane, claimed, tc, t64)
    hit = ~dis & (ids >= 0)
    np.testing.assert_allclose(t[hit], ref_t[hit], rtol=1e-5)


def _both_closest(blob, o, d, frame=None):
    mesh, jtb, tb = blob
    jt, jid = jax_packet.closest_hit(jax_make_rays(jnp.asarray(o), jnp.asarray(d)), jtb,
                                     frame=frame)
    t, pid, conv = packet.closest_hit(make_rays(torch.as_tensor(o), torch.as_tensor(d)), tb,
                                      frame=frame, with_conv=True)
    assert bool(conv.all())
    bt, bid = mesh_brute_force(jax_make_rays(jnp.asarray(o), jnp.asarray(d)),
                               jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices))
    return (pid.numpy(), t.numpy()), (np.asarray(jid), np.asarray(jt)), (np.asarray(bid), np.asarray(bt))


@pytest.mark.parametrize("case", ["mixed", "frame"])
def test_closest_hit_matches_jax_and_brute_force(blob, case):
    o, d = _mixed() if case == "mixed" else _frame()
    port, jax_side, brute = _both_closest(blob, o, d, frame=None if case == "mixed" else (41, 29))
    assert (port[0] >= 0).sum() > 300 and (port[0] < 0).sum() > 100
    _assert_agree(blob[0], o, d, *port, *jax_side)
    _assert_agree(blob[0], o, d, *port, *brute)


def test_any_hit_matches_jax_and_brute_force(blob):
    mesh, jtb, tb = blob
    o, d = _mixed(seed=1)
    jrays = jax_make_rays(jnp.asarray(o), jnp.asarray(d), tmax=4.0)
    want = np.asarray(jax_packet.any_hit(jrays, jtb))
    brute = np.asarray(mesh_brute_force_anyhit(jrays, jnp.asarray(mesh.vertices),
                                               jnp.asarray(mesh.indices)))
    got, conv = packet.any_hit(make_rays(torch.as_tensor(o), torch.as_tensor(d), tmax=4.0), tb,
                               with_conv=True)
    got = got.numpy()
    assert bool(conv.all()) and got.sum() > 300 and (~got).sum() > 100
    assert (got != want).mean() <= 0.005 and (got != brute).mean() <= 0.005


def test_pause_and_resume_rounds(blob, monkeypatch):
    """K_EMIT = 16 (fewer than the blob's treelets) forces several rounds;
    the result still matches brute force and the JAX package at the same
    budget."""
    mesh, jtb, tb = blob
    o, d = _mixed(n=256, seed=7)
    monkeypatch.setattr(packet, "K_EMIT", 16)
    monkeypatch.setattr(jax_packet, "K_EMIT", 16)
    rounds = []
    dispatch = packet._dispatch_hits

    def spy(*args):
        rounds.append(args[3].clone())  # the round's emission counts
        return dispatch(*args)

    monkeypatch.setattr(packet, "_dispatch_hits", spy)
    port, jax_side, brute = _both_closest(blob, o, d)
    assert len(rounds) > 1 and int(rounds[0].max()) > 16 - 8
    _assert_agree(mesh, o, d, *port, *jax_side)
    _assert_agree(mesh, o, d, *port, *brute)


def _rebinding_walk(top, top_ref, D, K, st, o, d, tmin, prune):
    """Phase A as it was written before its body updated fixed buffers in
    place: every step rebinds a name to a new tensor. The reference that the
    in-place walk (the body a CUDA graph captures) must equal bit for bit."""
    INF, C, R = packet._INF, o.shape[0], top.shape[0]
    inv_d = 1.0 / d
    eids = torch.zeros((C, K), dtype=torch.int64)
    enear = torch.full((C, K), INF, dtype=torch.float32)
    en = torch.zeros(C, dtype=torch.int64)
    st.paused = torch.zeros_like(st.paused)
    kiota, slot8, rows = torch.arange(K)[None, :], torch.arange(8)[None, :], torch.arange(C)
    amax = prune.amax(dim=1)
    o_, inv_, tmin_, prune_ = o[:, None], inv_d[:, None], tmin[:, None], prune[:, None]
    it = 0
    while it < packet.MAX_IT and bool((~st.done & ~st.paused).any()):
        for _ in range(min(packet.CHECK_EVERY, packet.MAX_IT - it)):
            active = ~st.done & ~st.paused
            visit = active & ~st.asc
            curc = st.cur.clamp(0, R - 1)
            row, ref = top[curc], top_ref[curc]
            t0 = (row[:, :, None, 0:3] - o_) * inv_
            t1 = (row[:, :, None, 3:6] - o_) * inv_
            near = torch.minimum(t0, t1).amax(dim=-1)
            far = torch.maximum(t0, t1).amin(dim=-1)
            ray_ok = (near <= far) & (far >= tmin_) & (near < prune_)
            child_hit = ray_ok.any(dim=-1)
            child_near = torch.where(ray_ok, torch.clamp_min(near, 0.0), INF).amin(dim=-1)
            hit_v = visit[:, None] & child_hit
            tre_key = torch.where(hit_v & (ref <= -2), child_near, INF)
            ikey = torch.where(hit_v & (ref >= 0), child_near, INF)
            tids = -2 - ref
            n_add = torch.zeros_like(en)
            for _ in range(8):
                sel = slot8 == tre_key.argmin(dim=1)[:, None]
                mn = tre_key.amin(dim=1)
                live = mn < INF
                tid = torch.where(sel, tids, 0).sum(dim=1)
                w = (kiota == (en + n_add)[:, None]) & live[:, None]
                eids = torch.where(w, tid[:, None], eids)
                enear = torch.where(w, mn[:, None], enear)
                n_add = n_add + live.long()
                tre_key = torch.where(sel, INF, tre_key)
            en = en + n_add
            c_sel = slot8 == ikey.argmin(dim=1)[:, None]
            has_child = visit & (ikey.amin(dim=1) < INF)
            c_ref = torch.where(c_sel, ref, 0).sum(dim=1)
            lvl = st.level.clamp(0, D - 1)
            s_near, s_ref = st.snear[rows, lvl], st.sref[rows, lvl]
            a_key = torch.where(s_near < amax[:, None], s_near, INF)
            a_sel = slot8 == a_key.argmin(dim=1)[:, None]
            a_has = st.asc & active & (a_key.amin(dim=1) < INF)
            a_ref = torch.where(a_sel, s_ref, 0).sum(dim=1)
            st.snear[rows, lvl] = torch.where(
                has_child[:, None], torch.where(c_sel, INF, ikey),
                torch.where(a_has[:, None] & a_sel, INF, s_near))
            st.sref[rows, lvl] = torch.where(has_child[:, None], ref, s_ref)
            go_asc = (visit & ~has_child) | (st.asc & active & ~a_has)
            descend = has_child | a_has
            st.cur = torch.where(has_child, c_ref, torch.where(a_has, a_ref, st.cur))
            st.level = torch.where(descend, lvl + 1, torch.where(go_asc, st.level - 1, st.level))
            st.asc = torch.where(descend, False, torch.where(go_asc, True, st.asc))
            st.done = st.done | (go_asc & (st.level < 0))
            st.paused = st.paused | (active & ~st.done & (en > K - 8))
        it += packet.CHECK_EVERY
    return eids, enear, en


STATE = [f.name for f in dataclasses.fields(packet.TravState)]


def _walks(monkeypatch, walk):
    """Each call of ``walk`` in place of ``packet._phase_a_chunk``: the
    state before it, its inputs and emissions, and the state after it."""
    calls = []

    def spy(tb, D, K, st, *ins):
        before = {f: getattr(st, f).clone() for f in STATE}
        out = walk(tb, D, K, st, *ins)
        calls.append((before, ins, out, {f: getattr(st, f).clone() for f in STATE}))
        return out

    monkeypatch.setattr(packet, "_phase_a_chunk", spy)
    return calls


def _bits(t):
    t = torch.as_tensor(np.array(t))
    return t.view(torch.int32) if t.dtype == torch.float32 else t.long()


@pytest.mark.parametrize("chunk", [packet.CHUNK_TILES, 3], ids=["one_chunk", "chunks_of_3"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_in_place_walk_matches_the_rebinding_walk_and_jax(blob, monkeypatch, any_hit, chunk):
    """The walk's in-place body, called through its fixed buffers (copy in,
    iterate, copy out, one buffer set shared by the chunks of a wavefront),
    with ``K_EMIT`` = 16 so tiles pause for several rounds: every call's
    emissions and resumed state, and the query's bt, bp and conv, bit for
    bit those of the walk that rebinds its names; and every call's emissions
    and state bit for bit those of the JAX package's phase A on the same
    state and inputs."""
    mesh, jtb, tb = blob
    o, d = _mixed(n=1024, seed=7)
    rays = make_rays(torch.as_tensor(o), torch.as_tensor(d), tmax=4.0 if any_hit else 5000.0)
    monkeypatch.setattr(packet, "K_EMIT", 16)
    monkeypatch.setattr(packet, "CHUNK_TILES", chunk)
    real = packet._phase_a_chunk
    ref = _walks(monkeypatch, lambda tb, D, K, st, *ins: _rebinding_walk(tb.top, tb.top_ref, D, K,
                                                                          st, *ins))
    want = packet._run(rays, tb, None, any_hit)
    got_calls = _walks(monkeypatch, real)
    got = packet._run(rays, tb, None, any_hit)
    n_chunks = -(-8 // min(chunk, 8))
    assert len(got_calls) == len(ref) > n_chunks  # several rounds
    assert int(got_calls[0][2][2].max()) > 16 - 8
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    for (b0, _, out, b1), (r0, _, rout, r1) in zip(got_calls, ref):
        for x, y in zip([*b0.values(), *out, *b1.values()], [*r0.values(), *rout, *r1.values()]):
            assert torch.equal(_bits(x), _bits(y))

    jwalk = jax.jit(jax_packet._phase_a_chunk, static_argnums=(1, 2))
    jtop = jnp.asarray(tb.top.numpy())
    D = max(tb.depth, 1)
    for before, ins, out, after in got_calls:
        jst = jax_packet.TravState(**{f: jnp.asarray(v.numpy().astype(np.int32) if v.dtype ==
                                                     torch.int64 else v.numpy())
                                      for f, v in before.items()})
        jafter, jout = jwalk(jtop, D, 16, jst, *(jnp.asarray(x.numpy()) for x in ins))
        for x, y in zip([*out, *after.values()],
                        [*jout, *(getattr(jafter, f) for f in STATE)]):
            assert torch.equal(_bits(x), _bits(y))


def test_walk_kernel_takes_cuda_tensors_only_and_the_cpu_runs_body(blob, monkeypatch):
    """On the CPU the walk's dispatch runs ``_body`` and counts no kernel
    iterations; the kernel's wrapper refuses CPU buffers, and buffers it
    cannot take, before it builds anything."""
    _, _, tb = blob
    D, cpu = max(tb.depth, 1), torch.device("cpu")
    wk = packet._Walk(dataclasses.replace(tb), 4, D, 16, cpu)
    body = []
    monkeypatch.setattr(packet, "_body", lambda w: body.append(w))
    monkeypatch.setattr(phase_a_walk, "build", lambda: pytest.fail("built on the CPU"))
    obs.reset()
    packet._iterate(wk, 3)
    assert body == [wk] * 3 and "packet.phase_a_kernel_iterations" not in obs.counters()
    for K, n in ((16, 4), (4, 4), (16, 0)):
        with pytest.raises(ValueError):
            phase_a_walk.walk(packet._Walk(dataclasses.replace(tb), 4, D, K, cpu), n)


def test_walk_bound_counts_one_launch_of_work(blob, monkeypatch):
    """The smoke's count of one walk launch's work, on the CPU with
    ``_body`` standing in for the kernel: the top-tree rows visited, the
    sibling-stack rows touched and the emissions written over the first
    ``CHECK_EVERY`` iterations from the root, which ``walk_bound`` prices
    below a read of every buffer whole."""
    import chip_smoke

    _, _, tb = blob
    o, d = _mixed(n=1024, seed=7)
    rays = make_rays(torch.as_tensor(o), torch.as_tensor(d))
    C, D, K, cpu = 8, max(tb.depth, 1), 16, torch.device("cpu")
    tile = lambda x: x.reshape(C, packet.TILE, *x.shape[1:])
    wk = packet._Walk(dataclasses.replace(tb), C, D, K, cpu)
    wk.load(packet._init_state(C, D, cpu), tile(rays.o), tile(rays.d), tile(rays.tmin),
            tile(rays.tmax))
    saved = chip_smoke.walk_twin(wk)
    monkeypatch.setattr(phase_a_walk, "walk",
                        lambda w, n: [packet._body(w) for _ in range(n)])
    launches, work = chip_smoke.check_walk_kernel(wk, saved)
    chip_smoke.restore_walk(wk, saved)
    for _ in range(packet.CHECK_EVERY):
        packet._body(wk)
    assert launches > 1 and work["emitted"] == int(wk.en.clamp(max=K).sum()) > 0
    assert 1 < work["top_rows"] < work["visits"] <= packet.CHECK_EVERY * C
    assert C <= work["stack_rows"] <= packet.CHECK_EVERY * C
    st = wk.st
    whole = chip_smoke.nbytes(wk.o, wk.inv_d, wk.tmin, wk.prune, wk.amax, wk.top, wk.top_ref,
                              wk.eids, wk.enear) \
        + 2 * chip_smoke.nbytes(st.cur, st.level, st.asc, st.done, st.paused, st.snear,
                                st.sref, wk.en)
    ms, _ = chip_smoke.walk_bound(wk, work)
    rays_ms, _ = chip_smoke.bound_ms(chip_smoke.nbytes(wk.o, wk.inv_d, wk.tmin, wk.prune), 0)
    assert rays_ms < ms < chip_smoke.bound_ms(whole, 0)[0]


def test_tiling_round_trip():
    x = torch.arange(41 * 29 * 3, dtype=torch.float32).reshape(41 * 29, 3)
    tiles = packet.to_tiles(x, 41, 29, fill=-1.0)
    assert tiles.shape == (4 * 3, packet.TILE, 3)  # 29 rows in 4 tiles of 8, 41 columns in 3 of 16
    assert torch.equal(packet.from_tiles(tiles, 41, 29), x)
    jt = np.asarray(jax_packet.to_tiles(jnp.asarray(x.numpy()), 41, 29, fill=-1.0))
    assert np.array_equal(tiles.numpy(), jt)

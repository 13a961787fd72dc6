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
from tracer_torch.accel import packet
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


def test_tiling_round_trip():
    x = torch.arange(41 * 29 * 3, dtype=torch.float32).reshape(41 * 29, 3)
    tiles = packet.to_tiles(x, 41, 29, fill=-1.0)
    assert tiles.shape == (4 * 3, packet.TILE, 3)  # 29 rows in 4 tiles of 8, 41 columns in 3 of 16
    assert torch.equal(packet.from_tiles(tiles, 41, 29), x)
    jt = np.asarray(jax_packet.to_tiles(jnp.asarray(x.numpy()), 41, 29, fill=-1.0))
    assert np.array_equal(tiles.numpy(), jt)

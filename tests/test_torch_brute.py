"""The brute-force engine and the path-mode pieces of the Cornell slice,
module by module, against ``tracer.kernels.intersect`` and
``tracer.render.integrator`` on the CPU, on the same seeded NumPy inputs:

* ``mesh_brute_force`` and ``mesh_brute_force_anyhit`` on the Cornell box
  fixture and on 64 seeded triangles (``chip_smoke.brute_case``); on CPU
  tensors they run their plain twins, never the kernel's wrapper
  (``kernels/brute_hits``), whose input checks run here too;
* ``sphere_t`` on random rays, rays exactly tangent to the sphere, origins
  inside it and empty windows (tmin == tmax);
* ``_area_light_attrs`` and ``_sample_area_light_mc`` on the W8 E3 scene;
* ``_fresnel_r``, total internal reflection included;
* ``_shade_transparent_path`` in each ``dielectric`` arm, on hits entering
  and leaving a sphere;
* ``trace_occluded`` on the W8 E3 scene (two spheres and the box).

Tolerances:
* Hit ids: the JAX package forms the Möller numerators as a matrix
  product, the port per pair, so the two round differently. On the rays
  not aimed at an edge, ids are equal on at least 99.5% of the lanes; on
  every lane where they differ (the edge-aimed rays included), the
  float64 re-test must find the lane borderline: some primitive within a
  relative 1e-4 of its acceptance boundary (barycentrics, window ends,
  the sphere's discriminant) or two primitives within 1e-4 of the same
  distance; and each claimed triangle must be a hit within 1e-4 of its
  boundary. Where the claims tie, their t agree within 1e-4 relative.
* t where the ids agree: rtol 1e-5. Any-hit and occlusion flags: equal
  except on borderline lanes.
* ``sphere_t``: valid equal except on borderline lanes, t at rtol 1e-6;
  the exactly tangent rays (discriminant 0 in both) hit at t = 300.
* Light samples, Fresnel and the dielectric: rtol 1e-5 (atol 1e-5 for
  unit vectors and weights, 1e-3 for positions of magnitude up to 600);
  the random state, the light slot, ``cont`` and ``emit`` bit for bit.

The JAX side runs in a child process (``python tests/test_torch_brute.py
OUT``), as in ``tests/test_torch_path.py``: pytest-xdist may run modules
that jit a render in the same worker, after which JAX's CPU backend fails
later calls (``ROADMAP.md`` §C).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from chip_smoke import brute_case, with_fixture_model
from tracer.kernels import intersect as jax_intersect
from tracer.render import integrator as jax_integrator
from tracer.scenes import build_scene as jax_build_scene
from tracer.scenes import get_scene as jax_get_scene

from tracer_torch import convert, obs
from tracer_torch.kernels import brute_hits, intersect
from tracer_torch.kernels.intersect import Rays
from tracer_torch.render import integrator
from tracer_torch.render.scene import SceneConfig

share_cores()

REPO = Path(__file__).resolve().parents[1]
EPS = 1e-4
KINDS = ("cornell", "seeded64")
ARMS = ("simple", "fresnel", "absorb")
SPHERE = (np.float32([130.0, 90.0, 250.0]), np.float32(90.0))  # the W8 glass ball
ROOM = (np.float32([0.0, 0.0, 0.0]), np.float32([556.0, 548.8, 559.2]))


# --- Seeded inputs ---------------------------------------------------------


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def sphere_case(seed: int = 0, n: int = 2048):
    """Rays at ``SPHERE``: (o, d, tmin, tmax, tangent). An eighth start
    inside it, an eighth are exactly tangent (axis-aligned, 300 from the
    tangent point: the discriminant is exactly 0 in float32), an eighth
    pass within 1e-3 of the radius, and a sixteenth have tmin == tmax."""
    rs = np.random.RandomState(seed)
    c, r = SPHERE
    o = c + _unit(rs.normal(size=(n, 3))) * rs.uniform(100.0, 400.0, (n, 1))
    d = _unit(c + rs.normal(0.0, 50.0, (n, 3)) - o)
    k = n // 8
    o[:k] = c + rs.uniform(-0.5, 0.5, (k, 3)) * r
    tangent = np.zeros(n, bool)
    tangent[k:2 * k] = True
    for j, lane in enumerate(range(k, 3 * k)):
        a, p, s = j % 3, (j // 3) % 3, 1.0 if (j // 9) % 2 else -1.0
        if p == a:
            p = (a + 1) % 3
        e_a, e_p = np.eye(3, dtype=np.float32)[a], np.eye(3, dtype=np.float32)[p]
        off = r if lane < 2 * k else r * (1.0 + rs.choice([-1e-3, 1e-3]))
        o[lane] = c + np.float32(off) * e_p - np.float32(s * 300.0) * e_a
        d[lane] = s * e_a
    tmin = np.full(n, 1e-2, np.float32)
    tmax = np.full(n, 5000.0, np.float32)
    empty = rs.rand(n) < 1.0 / 16
    tmax[empty] = tmin[empty]
    return o.astype(np.float32), d, tmin, tmax, tangent


def room_rays(seed: int, n: int = 2048):
    """Shadow-like rays inside the Cornell box: from a random point toward
    another, ending short of it (tmax = 0.3-1.0 of the way, less eta). A
    quarter of the targets lie outside the box, so the walls, floor and
    ceiling block those rays; the others can be blocked by the spheres and
    the light quad."""
    rs = np.random.RandomState(seed)
    lo, hi = ROOM
    o = (lo + rs.uniform(0.02, 0.98, (n, 3)) * (hi - lo)).astype(np.float32)
    tgt = lo + rs.uniform(0.0, 1.0, (n, 3)) * (hi - lo)
    out = rs.rand(n) < 0.25
    tgt[out] = lo + rs.uniform(-1.0, 2.0, (out.sum(), 3)) * (hi - lo)
    dist = np.linalg.norm(tgt - o, axis=1)
    d = _unit(tgt - o)
    tmin = np.full(n, 1e-2, np.float32)
    tmax = (dist * rs.uniform(0.3, 1.0, n) - 1e-2).astype(np.float32)
    return o, d, tmin, tmax


def light_case(seed: int, n: int = 2048):
    """Shading points in the box and random u32 states: (pos, state)."""
    rs = np.random.RandomState(seed)
    lo, hi = ROOM
    pos = (lo + rs.uniform(0.0, 1.0, (n, 3)) * (hi - lo)).astype(np.float32)
    return pos, rs.randint(0, 2 ** 32, n, dtype=np.int64)


def fresnel_case(seed: int, n: int = 4096):
    """(cos_i, cos_t, ni_over_nt): entering (1.5) and leaving (1/1.5)
    lanes; cos_t is 0 where the leaving ray is totally reflected."""
    rs = np.random.RandomState(seed)
    cos_i = rs.uniform(0.0, 1.0, n).astype(np.float32)
    ior = np.where(rs.rand(n) < 0.5, np.float32(1.5), np.float32(1.0) / np.float32(1.5))
    cos_t2 = 1.0 - ior * ior * (1.0 - cos_i * cos_i)
    return cos_i, np.sqrt(np.maximum(cos_t2, 0.0)).astype(np.float32), ior.astype(np.float32)


def transparent_case(seed: int, n: int = 2048) -> dict:
    """Hits on the glass ball from random directions (about half of them
    from inside), with origins 1-300 back along the ray, random
    throughput and random u32 states: the hit record's fields as arrays,
    and ``o``, ``d``, ``factor``, ``state``."""
    rs = np.random.RandomState(seed)
    c, r = SPHERE
    nrm = _unit(rs.normal(size=(n, 3)))
    pos = (c + r * nrm).astype(np.float32)
    d = _unit(rs.normal(size=(n, 3)))
    dist = rs.uniform(1.0, 300.0, n).astype(np.float32)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    z3 = np.zeros((n, 3), np.float32)
    hit = dict(
        valid=np.ones(n, bool), t=dist, position=pos, normal=nrm,
        shader=np.full(n, 7, np.int32), albedo=z3, emission=z3,
        specular=np.zeros(n, np.float32), shininess=np.zeros(n, np.float32),
        ior=np.full(n, 1.5, np.float32), extinction=f32(np.tile([0.5, 0.2, 0.2], (n, 1))),
        uv=np.zeros((n, 2), np.float32), textured=np.zeros(n, bool),
        is_mesh=np.zeros(n, bool), converged=np.ones(n, bool),
    )
    return dict(hit=hit, o=f32(pos - dist[:, None] * d), d=d,
                factor=rs.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
                state=rs.randint(0, 2 ** 32, n, dtype=np.int64))


# --- The float64 re-test -----------------------------------------------------


def tri_margins(o, d, tmin, tmax, verts, idx):
    """float64 (margin, t), each (N, T): the least of beta, gamma,
    1 - beta - gamma and the window's two margins (relative to max(1, |t|)),
    positive inside the acceptance region; -inf where the denominator is 0."""
    o, d, V = (np.asarray(x, np.float64) for x in (o, d, verts))
    tmin, tmax = np.asarray(tmin, np.float64), np.asarray(tmax, np.float64)
    v0, v1, v2 = (V[idx[:, k]][None] for k in range(3))
    e0, e1 = v1 - v0, v2 - v0
    n = np.cross(e0, e1)
    ov = v0 - o[:, None]
    nom = np.cross(ov, d[:, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        dn = (d[:, None] * n).sum(-1)
        beta = (nom * e1).sum(-1) / dn
        gamma = -(nom * e0).sum(-1) / dn
        t = (ov * n).sum(-1) / dn
        scale = np.maximum(np.abs(t), 1.0)
        m = np.minimum.reduce([beta, gamma, 1.0 - beta - gamma,
                               (t - tmin[:, None]) / scale, (tmax[:, None] - t) / scale])
    return np.where(np.isnan(m), -np.inf, m), t


def borderline(o, d, tmin, tmax, verts=None, idx=None, spheres=()):
    """Lanes whose answer can turn on float32 rounding: a triangle within
    ``EPS`` of its acceptance boundary, a sphere whose discriminant or a
    root of it is within ``EPS`` (relative) of 0 or of a window end, or
    the two nearest accepted primitives within ``EPS`` of each other."""
    o64, d64 = np.asarray(o, np.float64), np.asarray(d, np.float64)
    tmin64, tmax64 = np.asarray(tmin, np.float64), np.asarray(tmax, np.float64)
    near = np.zeros(o64.shape[0], bool)
    ts = [np.full((o64.shape[0], 2), np.inf)]
    if verts is not None:
        m, t = tri_margins(o, d, tmin, tmax, verts, idx)
        near |= (np.abs(m) <= EPS).any(axis=1)
        ts.append(np.where(m >= 0, t, np.inf))
    for c, r in spheres:
        oc = o64 - np.asarray(c, np.float64)
        a = (d64 * d64).sum(1)
        b2 = (oc * d64).sum(1)
        cc = (oc * oc).sum(1) - float(r) ** 2
        disc = b2 * b2 - a * cc
        near |= np.abs(disc) <= EPS * (b2 * b2 + np.abs(a * cc))
        sq = np.sqrt(np.maximum(disc, 0.0))
        roots = [(-b2 - sq) / a, (-b2 + sq) / a]
        ok = []
        for root in roots:
            scale = np.maximum(np.abs(root), 1.0)
            near |= (disc >= 0) & ((np.abs(root - tmin64) <= EPS * scale)
                                   | (np.abs(tmax64 - root) <= EPS * scale))
            ok.append((disc >= 0) & (root >= tmin64) & (root <= tmax64))
        ts.append(np.where(ok[0], roots[0], np.where(ok[1], roots[1], np.inf))[:, None])
    t_all = np.sort(np.concatenate(ts, axis=1), axis=1)
    with np.errstate(invalid="ignore"):
        tie = (t_all[:, 1] - t_all[:, 0]) <= EPS * np.maximum(np.abs(t_all[:, 0]), 1.0)
    return near | (np.isfinite(t_all[:, 0]) & tie)


def check_ids(ids, ref, t, t_ref, case, edge=None):
    """The hit-id rule of the module docstring; ``case`` = (vertices,
    indices, o, d, tmin, tmax) of the mesh query."""
    verts, idx, o, d, tmin, tmax = case
    dis = ids != ref
    plain = np.ones_like(dis) if edge is None else ~edge
    assert dis[plain].mean() <= 0.005, f"{dis[plain].sum()} of {plain.sum()} ids differ"
    border = borderline(o, d, tmin, tmax, verts, idx)
    assert border[dis].all(), f"lanes {np.nonzero(dis & ~border)[0]} differ and are not borderline"
    m, t64 = tri_margins(o, d, tmin, tmax, verts, idx)
    for lane in np.nonzero(dis)[0]:
        claims = [c for c in (ids[lane], ref[lane]) if c >= 0]
        assert all(m[lane, c] >= -EPS for c in claims), (lane, claims, m[lane, claims])
        if len(claims) == 2 and abs(t64[lane, claims[0]] - t64[lane, claims[1]]) <= \
                EPS * max(1.0, abs(t64[lane, claims[0]])):
            assert abs(t[lane] - t_ref[lane]) <= EPS * abs(t_ref[lane]), lane
    same = ~dis & (ref >= 0)
    np.testing.assert_allclose(t[same], t_ref[same], rtol=1e-5)
    return dis


# --- The JAX side (child process) -----------------------------------------


def _jrays(o, d, tmin, tmax):
    return jax_intersect.Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                              jnp.asarray(tmax))


def _w8e3_jax(width: int = 16):
    desc = with_fixture_model(jax_get_scene("W8 E3 Absorption"))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=width,
                                                             height=width))
    return jax_build_scene(desc)


def _write_jax_side(out: Path) -> None:
    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {}
    for kind in KINDS:
        verts, idx, *rays, _ = brute_case(kind, 0)
        jr = _jrays(*rays)
        t, ids = jax_intersect.mesh_brute_force(jr, jnp.asarray(verts), jnp.asarray(idx))
        blocked = jax_intersect.mesh_brute_force_anyhit(jr, jnp.asarray(verts), jnp.asarray(idx))
        side[kind] = dict(t=np.asarray(t), ids=np.asarray(ids), blocked=np.asarray(blocked))
    o, d, tmin, tmax, _ = sphere_case()
    t, ok = jax_intersect.sphere_t(_jrays(o, d, tmin, tmax), jnp.asarray(SPHERE[0]),
                                   jnp.asarray(SPHERE[1]))
    side["sphere"] = dict(t=np.asarray(t), valid=np.asarray(ok))

    scene, cfg = _w8e3_jax()
    side["scene"], side["cfg"] = jax.tree.map(np.asarray, scene), cfg
    pos, state = light_case(0)
    L = int(scene.light_indices.shape[0])
    slot = jnp.asarray((state % L).astype(np.int32))
    attrs = jax_integrator._area_light_attrs(scene, slot)
    smp = jax_integrator._sample_area_light_mc(scene, jnp.asarray(pos), slot,
                                               jnp.asarray(state.astype(np.uint32)))
    side["light"] = dict(attrs=[np.asarray(x) for x in attrs],
                         sample=[np.asarray(x) for x in smp])
    b, conv = jax_integrator.trace_occluded(scene, cfg, _jrays(*room_rays(0)), with_conv=True)
    side["occluded"] = dict(blocked=np.asarray(b), conv=np.asarray(conv))
    side["fresnel"] = np.asarray(jax_integrator._fresnel_r(*map(jnp.asarray, fresnel_case(0))))

    tc = transparent_case(0)
    hit = jax_integrator.Hit(**{k: jnp.asarray(v) for k, v in tc["hit"].items()})
    rays = _jrays(tc["o"], tc["d"], np.zeros(len(tc["d"]), np.float32),
                  np.full(len(tc["d"]), 5000.0, np.float32))
    side["transparent"] = {}
    for arm in ARMS:
        c, nr, ct, f, e, s = jax_integrator._shade_transparent_path(
            None, dataclasses.replace(cfg, dielectric=arm), rays, hit,
            jnp.asarray(tc["factor"]), jnp.asarray(tc["state"].astype(np.uint32)))
        side["transparent"][arm] = dict(
            color=np.asarray(c), o=np.asarray(nr.o), d=np.asarray(nr.d),
            tmin=np.asarray(nr.tmin), tmax=np.asarray(nr.tmax), cont=np.asarray(ct),
            factor=np.asarray(f), emit=np.asarray(e), state=np.asarray(s))
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_brute") / "jax_side.pkl"
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": path})
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


# --- Tests -----------------------------------------------------------------


def _rays(o, d, tmin, tmax) -> Rays:
    return Rays(*(torch.as_tensor(x) for x in (o, d, tmin, tmax)))


def _port_cfg(cfg, **kw) -> SceneConfig:
    port = SceneConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(SceneConfig)})
    return dataclasses.replace(port, **kw)


def _close(a, b, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_brute_force_matches_jax(jax_side, kind):
    verts, idx, o, d, tmin, tmax, edge = brute_case(kind, 0)
    t, ids = intersect.mesh_brute_force(_rays(o, d, tmin, tmax), torch.as_tensor(verts),
                                        torch.as_tensor(idx))
    ref = jax_side[kind]
    assert ids.dtype == torch.int32 and (ref["ids"] >= 0).mean() > 0.4
    dis = check_ids(ids.numpy(), ref["ids"], t.numpy(), ref["t"],
                    (verts, idx, o, d, tmin, tmax), edge)
    miss = ids.numpy() < 0
    assert np.array_equal(t.numpy()[miss], tmax[miss])
    assert dis[edge].any(), "no edge-aimed ray was disputed: the re-test went unexercised"


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_brute_force_anyhit_matches_jax(jax_side, kind):
    verts, idx, o, d, tmin, tmax, _ = brute_case(kind, 0)
    rays = _rays(o, d, tmin, tmax)
    blocked = intersect.mesh_brute_force_anyhit(rays, torch.as_tensor(verts),
                                                torch.as_tensor(idx)).numpy()
    dis = blocked != jax_side[kind]["blocked"]
    assert borderline(o, d, tmin, tmax, verts, idx)[dis].all()
    # Any hit in the window is a closest hit too.
    _, ids = intersect.mesh_brute_force(rays, torch.as_tensor(verts), torch.as_tensor(idx))
    assert np.array_equal(blocked, ids.numpy() >= 0)
    assert not blocked[tmin == tmax].any()


def test_brute_force_chunks_do_not_change_the_result(monkeypatch):
    verts, idx, *rays, _ = brute_case("seeded64", 1, n=1024)
    args = (_rays(*rays), torch.as_tensor(verts), torch.as_tensor(idx))
    whole = intersect.mesh_brute_force(*args), intersect.mesh_brute_force_anyhit(*args)
    monkeypatch.setattr(intersect, "PAIR_BUDGET", 1024 * 5)  # chunks of 5 triangles
    parts = intersect.mesh_brute_force(*args), intersect.mesh_brute_force_anyhit(*args)
    assert torch.equal(whole[0][0], parts[0][0]) and torch.equal(whole[0][1], parts[0][1])
    assert torch.equal(whole[1], parts[1])


def test_sphere_t_matches_jax(jax_side):
    o, d, tmin, tmax, tangent = sphere_case()
    t, ok = intersect.sphere_t(_rays(o, d, tmin, tmax), torch.as_tensor(SPHERE[0]),
                               torch.as_tensor(SPHERE[1]))
    t, ok = t.numpy(), ok.numpy()
    ref = jax_side["sphere"]
    dis = ok != ref["valid"]
    assert borderline(o, d, tmin, tmax, spheres=[SPHERE])[dis].all()
    both = ok & ref["valid"]
    np.testing.assert_allclose(t[both], ref["t"][both], rtol=1e-6)
    live = tangent & (tmax > tmin)
    assert ok[live].all() and ref["valid"][live].all() and (t[live] == 300.0).all()
    assert not ok[tmax == tmin].any()
    inside = np.linalg.norm(o - SPHERE[0], axis=1) < SPHERE[1]
    assert ok[inside & (tmax > tmin)].all()  # the far root


def test_area_light_sample_matches_jax(jax_side):
    scene = convert.scene_from_arrays(jax_side["scene"], "cpu")
    pos, state = light_case(0)
    L = scene.light_indices.shape[0]
    assert L == 2
    slot = torch.as_tensor(state % L)
    ref = jax_side["light"]
    for got, want in zip(integrator._area_light_attrs(scene, slot), ref["attrs"]):
        _close(got, want, atol=1e-3)
    l_i, w_i, dist, st = integrator._sample_area_light_mc(
        scene, torch.as_tensor(pos), slot, torch.as_tensor(state))
    r_li, r_wi, r_dist, r_st = ref["sample"]
    _close(l_i, r_li, atol=1e-5)
    _close(w_i, r_wi)
    _close(dist, r_dist, atol=1e-3)
    assert np.array_equal(st.numpy(), r_st.astype(np.int64))
    # The light faces down: lit points lie below it, and cos_l > 0 there.
    below = pos[:, 1] < 548.3
    assert (l_i.numpy()[below] > 0).all() and (l_i.numpy()[~below] == 0).all()


def test_fresnel_r_matches_jax(jax_side):
    cos_i, cos_t, ior = fresnel_case(0)
    got = integrator._fresnel_r(*map(torch.as_tensor, (cos_i, cos_t, ior))).numpy()
    _close(got, jax_side["fresnel"])
    assert (cos_t == 0).sum() > 100  # total internal reflection lanes


@pytest.mark.parametrize("arm", ARMS)
def test_transparent_path_matches_jax(jax_side, arm):
    tc = transparent_case(0)
    hit = integrator.Hit(**{k: torch.as_tensor(v) for k, v in tc["hit"].items()})
    n = len(tc["d"])
    rays = _rays(tc["o"], tc["d"], np.zeros(n, np.float32), np.full(n, 5000.0, np.float32))
    cfg = _port_cfg(jax_side["cfg"], dielectric=arm)
    c, nr, ct, f, e, s = integrator._shade_transparent_path(
        None, cfg, rays, hit, torch.as_tensor(tc["factor"]), torch.as_tensor(tc["state"]))
    ref = jax_side["transparent"][arm]
    assert np.array_equal(ct.numpy(), ref["cont"]) and np.array_equal(e.numpy(), ref["emit"])
    assert np.array_equal(s.numpy(), ref["state"].astype(np.int64))
    _close(c, ref["color"])
    _close(nr.o, ref["o"], atol=1e-3)
    _close(nr.d, ref["d"])
    assert np.array_equal(nr.tmin.numpy(), ref["tmin"]) and np.array_equal(nr.tmax.numpy(),
                                                                            ref["tmax"])
    _close(f, ref["factor"])
    entering = (tc["d"] * tc["hit"]["normal"]).sum(1) > 0  # the reference's sign convention
    assert entering.any() and (~entering).any()
    absorbed = ~ct.numpy()
    assert absorbed.any() == (arm == "absorb")


def test_trace_occluded_matches_jax(jax_side):
    scene = convert.scene_from_arrays(jax_side["scene"], "cpu")
    cfg = _port_cfg(jax_side["cfg"])
    assert cfg.traversal == "brute" and scene.tb is None and scene.spheres is not None
    o, d, tmin, tmax = room_rays(0)
    blocked, conv = integrator.trace_occluded(scene, cfg, _rays(o, d, tmin, tmax))
    ref = jax_side["occluded"]
    assert conv.numpy().all() and ref["conv"].all()
    dis = blocked.numpy() != ref["blocked"]
    geom = jax_side["scene"].geom
    sp = jax_side["scene"].spheres
    spheres = list(zip(sp.center, sp.radius))
    assert borderline(o, d, tmin, tmax, geom.vertices, np.asarray(geom.indices), spheres)[dis].all()
    by_mesh = intersect.mesh_brute_force_anyhit(_rays(o, d, tmin, tmax), scene.geom.vertices,
                                                scene.geom.indices).numpy()
    assert by_mesh.mean() > 0.05 and (blocked.numpy() & ~by_mesh).mean() > 0.05


QUERIES = {"closest": ("mesh_brute_force", "mesh_brute_force_reference", "closest"),
           "any_hit": ("mesh_brute_force_anyhit", "mesh_brute_force_anyhit_reference", "any_hit")}


@pytest.mark.parametrize("query", list(QUERIES))
def test_cpu_tensors_take_the_twin(monkeypatch, query):
    """On CPU tensors a query runs its plain twin and never the kernel's
    wrapper: the same result as the twin's, ``brute.pairs`` counts rays x
    triangles and ``brute.kernel_pairs`` stays at 0."""
    entry, twin, kernel = QUERIES[query]
    verts, idx, *rays, _ = brute_case("seeded64", 2, n=500)
    args = (_rays(*rays), torch.as_tensor(verts), torch.as_tensor(idx))
    calls = []

    def refuse(*a):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    def spy(*a, fn=getattr(intersect, twin)):
        calls.append(1)
        return fn(*a)

    monkeypatch.setattr(brute_hits, kernel, refuse)
    monkeypatch.setattr(intersect, twin, spy)
    obs.reset()
    try:
        got = getattr(intersect, entry)(*args)
        assert calls == [1]
        assert obs.counters().get("brute.pairs") == 500 * 64
        assert obs.counters().get("brute.kernel_pairs", 0) == 0
    finally:
        obs.reset()
    want = getattr(intersect, twin)(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


_swap = dataclasses.replace
# One wrong input at a time, as (rays, vertices, indices) -> the same with it.
BAD_INPUTS = {
    "o_float64": lambda r, v, i: (_swap(r, o=r.o.double()), v, i),
    "o_flat": lambda r, v, i: (_swap(r, o=r.o.reshape(-1)), v, i),
    "d_two_columns": lambda r, v, i: (_swap(r, d=r.d[:, :2]), v, i),
    "tmin_short": lambda r, v, i: (_swap(r, tmin=r.tmin[:-1]), v, i),
    "tmax_int32": lambda r, v, i: (_swap(r, tmax=r.tmax.int()), v, i),
    "tmax_scalar": lambda r, v, i: (_swap(r, tmax=r.tmax[0]), v, i),
    "vertices_float64": lambda r, v, i: (r, v.double(), i),
    "vertices_four_columns": lambda r, v, i: (r, torch.cat([v, v[:, :1]], 1), i),
    "indices_int64": lambda r, v, i: (r, v, i.long()),
    "indices_float32": lambda r, v, i: (r, v, i.float()),
    "indices_two_columns": lambda r, v, i: (r, v, i[:, :2]),
    "on_the_cpu": lambda r, v, i: (r, v, i),
}


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("bad", list(BAD_INPUTS))
def test_kernel_wrapper_rejects_what_it_cannot_take(query, bad):
    """The kernel's wrapper raises ``ValueError`` on a wrong dtype or shape
    (indices other than int32 included) before it looks at the device, and
    on CPU tensors that it would otherwise take: it launches on CUDA only."""
    verts, idx, *rays, _ = brute_case("cornell", 0, n=64)
    args = BAD_INPUTS[bad](_rays(*rays), torch.as_tensor(verts), torch.as_tensor(idx))
    match = "CUDA only" if bad == "on_the_cpu" else "wants"
    with pytest.raises(ValueError, match=match):
        getattr(brute_hits, QUERIES[query][2])(*args)


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

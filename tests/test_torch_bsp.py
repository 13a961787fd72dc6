"""The BSP tree of the port (``tracer_torch.accel.bsp``): its builders and
its walk, against the JAX package's ``tracer.accel.bsp``.

* Builders: the port's NumPy and native (``native/bsp.cpp``, compiled by
  the port with ``-ffp-contract=off``) builders are bitwise equal to each
  other and to the JAX package's ``BspBuffers`` on the bunny stand-in and
  both Cornell fixtures, at the default ``max_depth``/``max_objects`` (20,
  4) and at (6, 2); ``validate`` holds on each. On the bunny at the
  default the JAX side runs its native builder only (its NumPy builder
  takes half a minute, and the port's NumPy build is held to the same
  tree).
* The walk: ``bsp_closest_hit`` and ``bsp_any_hit`` on seeded rays against
  the bunny stand-in and the Cornell box with blocks, against the JAX
  package's on the same tree and vertices: ids equal, t equal at rtol
  1e-5 (XLA contracts the Möller test's products into FMAs, the port
  rounds each), any-hit masks equal, except on disputed lanes. A lane is
  disputed when the float64 re-test of ``tests/test_torch_direct.py``
  (``query_borderline``) finds it within float32 noise of an edge or of
  its window; there each claimed hit is re-tested in float64 and its t
  checked.
* Frames: ``Project: Bunny BSP`` with ``bsp_execution="walk"`` at 32x24
  renders the frame of the treelet engine (``"fast"``), as
  ``tests/test_oracle_parity.py::test_bsp_fast_execution_matches_walk``
  holds for the JAX package (allclose at atol 1e-5 on at least 99.5% of
  the pixels), and its statistics meet the JAX package's walk frame at
  ``DIRECT_RTOL``. ``W8 E3 Absorption`` at 16x16 with the BSP walk forced
  (the build sends its 12 triangles to brute force, so the test attaches
  the tree itself) renders the brute-force frame (atol 1e-4 on at least
  99.5% of the pixels, as ``test_cornell_path_bsp_equals_brute``).

The JAX side runs in a child process (``python tests/test_torch_bsp.py
OUT``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _share_cores import share_cores
from test_torch_direct import query_borderline

from chip_smoke import DIRECT_RTOL, FIXTURES, path_errors, path_stats, with_fixture_model

from tracer_torch.accel import bsp
from tracer_torch.geometry.obj import load_obj
from tracer_torch.geometry.procedural import standin_for
from tracer_torch.kernels.intersect import Rays
from tracer_torch.render import integrator, progressive
from tracer_torch.scenes.build import build_scene, load_mesh
from tracer_torch.scenes.registry import get_scene

share_cores()

REPO = Path(__file__).resolve().parents[1]
MESHES = ("bunny.obj", "CornellBox.obj", "CornellBoxWithBlocks.obj")
PARAMS = ((bsp.MAX_DEPTH_DEFAULT, bsp.MAX_OBJECTS_DEFAULT), (6, 2))
WALK_MESHES = ("bunny.obj", "CornellBoxWithBlocks.obj")
FIELDS = ("axis", "plane", "left", "right", "first", "count", "prim_ids", "bbox_lo", "bbox_hi")
BUNNY_W, BUNNY_H = 32, 24


def mesh_of(name: str, load, standin):
    """The mesh ``name`` by the loaders of either package: the bunny
    stand-in or a Cornell fixture."""
    return standin(name) if name == "bunny.obj" else load(str(FIXTURES / name))


def seeded_rays(vertices, n: int, seed: int):
    """(o, d, tmin, tmax) of ``n`` rays from around the mesh toward its
    middle (``tests/test_accel.py``'s ``_rand_rays``), a quarter of them
    with windows that end inside the mesh's extent."""
    rs = np.random.RandomState(seed)
    lo, hi = vertices.min(axis=0), vertices.max(axis=0)
    c, ext = (lo + hi) / 2, float(np.max(hi - lo))
    o = (c + rs.randn(n, 3) * ext).astype(np.float32)
    d = (c + rs.randn(n, 3) * ext * 0.3).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 5000.0, np.float32)
    tmax[: n // 4] = (np.linalg.norm(o[: n // 4] - c, axis=1)
                      * rs.uniform(0.5, 1.2, n // 4)).astype(np.float32)
    return o, d.astype(np.float32), tmin, tmax


def _bunny_desc(get, execution: str):
    desc = get("Project: Bunny BSP")
    return dataclasses.replace(desc, cfg=dataclasses.replace(
        desc.cfg, width=BUNNY_W, height=BUNNY_H, bsp_execution=execution))


def _write_jax_side(out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from tracer.accel import bsp as jax_bsp
    from tracer.geometry.obj import load_obj as jax_load_obj
    from tracer.geometry.procedural import standin_for as jax_standin_for
    from tracer.kernels.intersect import Rays as JaxRays
    from tracer.render import integrator as jax_integrator
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene

    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {"trees": {}, "walks": {}}
    for name in MESHES:
        mesh = mesh_of(name, jax_load_obj, jax_standin_for)
        lo, hi = mesh.bboxes()
        for depth, objects in PARAMS:
            for native in (True, False):
                if not native and name == "bunny.obj" and depth == bsp.MAX_DEPTH_DEFAULT:
                    continue
                tree = jax_bsp.build(lo, hi, depth, objects, prefer_native=native)
                side["trees"][name, depth, objects, native] = tree
        if name in WALK_MESHES:
            tree = side["trees"][name, *PARAMS[0], True]
            dev_tree = jax.tree.map(jnp.asarray, tree)
            V, I = jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
            rays = JaxRays(*map(jnp.asarray, seeded_rays(mesh.vertices, 2048, 0)))
            t, pid, conv = jax_bsp.bsp_closest_hit(rays, dev_tree, V, I, with_conv=True)
            blocked, aconv = jax_bsp.bsp_any_hit(rays, dev_tree, V, I, with_conv=True)
            side["walks"][name] = dict(t=np.asarray(t), pid=np.asarray(pid),
                                       conv=np.asarray(conv), blocked=np.asarray(blocked),
                                       aconv=np.asarray(aconv))
    scene, cfg = jax_build_scene(_bunny_desc(jax_get_scene, "walk"))
    side["bunny_walk"] = np.asarray(jax.jit(jax_integrator.render_sample,
                                            static_argnames="cfg")(scene, cfg=cfg))
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_bsp") / "jax_side.pkl"
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": path,
                                         "TRACER_NO_SCENE_CACHE": "1"})
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


def _mesh(name):
    return mesh_of(name, load_obj, standin_for)


def _assert_same_tree(a, b, what):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert np.array_equal(x.view(np.int32), y.view(np.int32)), (what, f)
    assert (a.max_level, a.max_count) == (b.max_level, b.max_count), what


@pytest.mark.parametrize("params", PARAMS, ids=lambda p: f"depth{p[0]}-objects{p[1]}")
@pytest.mark.parametrize("name", MESHES)
def test_builders_bitwise(jax_side, name, params):
    mesh = _mesh(name)
    lo, hi = mesh.bboxes()
    native = bsp.build(lo, hi, *params)
    numpy_tree = bsp.build(lo, hi, *params, prefer_native=False)
    bsp.validate(native, mesh.num_triangles)
    _assert_same_tree(native, numpy_tree, "port native vs port NumPy")
    for jax_native in (True, False):
        theirs = jax_side["trees"].get((name, *params, jax_native))
        if theirs is not None:
            _assert_same_tree(native, theirs, f"port vs JAX (native={jax_native})")


def _float64_hit(o, d, v0, v1, v2):
    """(t, smallest barycentric) of one ray against one triangle, float64."""
    o, d, v0, v1, v2 = (np.asarray(x, np.float64) for x in (o, d, v0, v1, v2))
    e0, e1 = v1 - v0, v2 - v0
    n = np.cross(e0, e1)
    ov = v0 - o
    nom = np.cross(ov, d)
    dn = d @ n
    beta, gamma = (nom @ e1) / dn, -(nom @ e0) / dn
    return (ov @ n) / dn, min(beta, gamma, 1.0 - beta - gamma)


@pytest.mark.parametrize("name", WALK_MESHES)
def test_walk_matches_jax(jax_side, name):
    mesh = _mesh(name)
    tree = bsp.to_device(bsp.build(*mesh.bboxes()), "cpu")
    V, I = torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.indices)
    o, d, tmin, tmax = seeded_rays(mesh.vertices, 2048, 0)
    rays = Rays(*map(torch.as_tensor, (o, d, tmin, tmax)))
    t, pid, conv = bsp.bsp_closest_hit(rays, tree, V, I, with_conv=True)
    blocked, aconv = bsp.bsp_any_hit(rays, tree, V, I, with_conv=True)
    t, pid, blocked = t.numpy(), pid.numpy(), blocked.numpy()
    want = jax_side["walks"][name]
    assert conv.all() and aconv.all() and want["conv"].all() and want["aconv"].all()
    assert (pid >= 0).sum() > 200 and blocked.sum() > 200
    assert 0 < (~blocked).sum()
    differ = (pid != want["pid"]) | (blocked != want["blocked"])
    assert differ.mean() <= 0.005, f"{differ.sum()} lanes differ"
    same = ~differ & (pid >= 0)
    np.testing.assert_allclose(t[same], want["t"][same], rtol=1e-5)
    lanes = np.nonzero(differ)[0]
    if lanes.size:
        near = query_borderline(o[lanes], d[lanes], tmin[lanes], tmax[lanes], mesh.vertices,
                                mesh.indices)
        assert near.all(), f"lanes {lanes[~near]} differ and are not disputed"
        for lane in lanes:
            for claim, tt in ((pid[lane], t[lane]), (want["pid"][lane], want["t"][lane])):
                if claim < 0:
                    continue
                v0, v1, v2 = mesh.vertices[mesh.indices[claim]]
                t64, bary = _float64_hit(o[lane], d[lane], v0, v1, v2)
                assert bary >= -1e-4 and abs(t64 - tt) <= 1e-4 * max(1.0, abs(t64)), (lane, claim)


def _frame(desc):
    scene, cfg = build_scene(desc, "cpu")
    return scene, cfg, integrator.render_sample(scene, cfg).numpy()


def _assert_close_frac(a, b, atol, frac):
    close = np.isclose(a, b, rtol=0, atol=atol).all(axis=-1)
    assert close.mean() >= frac, f"{(~close).sum()} pixels differ"


def test_bunny_bsp_walk_frame(jax_side):
    scene_w, cfg_w, walk = _frame(_bunny_desc(get_scene, "walk"))
    assert cfg_w.traversal == "bsp" and scene_w.bsp is not None and scene_w.tb is None
    assert scene_w.bsp.max_count > 100  # leaves at the depth cap
    scene_f, cfg_f, fast = _frame(_bunny_desc(get_scene, "fast"))
    assert scene_f.tb is not None and scene_f.bsp is None
    _assert_close_frac(walk, fast, 1e-5, 0.995)
    stats = path_stats(jax_side["bunny_walk"])
    assert path_errors(path_stats(walk), DIRECT_RTOL, stats) == []


def test_cornell_path_bsp_walk_equals_brute(monkeypatch):
    desc = with_fixture_model(get_scene("W8 E3 Absorption"))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=16, height=16))
    scene, cfg = build_scene(desc, "cpu")
    assert cfg.traversal == "brute"
    mesh = load_mesh(desc.model, desc.model_scale)
    walk_scene = dataclasses.replace(scene, bsp=bsp.to_device(bsp.build_for_mesh(mesh), "cpu"))
    walk_cfg = dataclasses.replace(cfg, traversal="bsp", bsp_execution="walk")
    seen = []
    orig = bsp.bsp_closest_hit

    def spy(*a, **k):
        seen.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(integrator.bsp_mod, "bsp_closest_hit", spy)
    walked = progressive.render_progressive(walk_scene, walk_cfg, 2).accum.numpy()
    assert seen
    brute = progressive.render_progressive(scene, cfg, 2).accum.numpy()
    assert walked.std() > 0.01
    _assert_close_frac(walked, brute, 1e-4, 0.995)


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

"""The per-ray ``bvh2`` walk (``tracer_torch.accel.traverse``) and the
agglomerative builder (``tracer_torch.accel.agglom``), against the JAX
package's ``tracer.accel.traverse`` and ``tracer.accel.agglom``.

* ``bvh_closest_hit`` and ``bvh_any_hit`` over the LBVH of the bunny
  stand-in and of the Cornell box with blocks, on the seeded rays of
  ``tests/test_torch_bsp.py``, against the JAX package's walks on the same
  tree: ids equal, t equal at rtol 1e-5 and any-hit masks equal, except on
  disputed lanes (the float64 re-test of ``query_borderline``), where each
  claimed hit is re-tested in float64 and its t checked. The LBVH itself
  is the port's NumPy build, held bitwise to the JAX package's.
* The agglomerative builder on ``tests/fixtures/CornellBox.obj`` (the
  file ``tests/test_accel.py`` names, ``test_object.obj``, is missing):
  ``lbvh.validate``'s invariants, the tree bitwise equal to the JAX
  package's, and its ``bvh_closest_hit`` ids equal to the brute-force
  engine's (``tests/test_accel.py:297-330``), at ``max_leaf`` 4; and the
  singleton case.
* ``Project: Bunny`` with ``traversal="bvh2"`` at 32x24: the frame of the
  treelet engine (allclose at atol 1e-5 on at least 99.5% of the pixels),
  and its statistics meet the JAX package's ``bvh2`` frame at
  ``DIRECT_RTOL``.

The JAX side runs in a child process (``python tests/test_torch_traverse.py
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
from test_torch_bsp import (WALK_MESHES, _assert_close_frac, _float64_hit, _frame, mesh_of,
                            seeded_rays)
from test_torch_direct import query_borderline

from chip_smoke import DIRECT_RTOL, FIXTURES, path_errors, path_stats

from tracer_torch.accel import agglom, lbvh, traverse
from tracer_torch.geometry.obj import load_obj
from tracer_torch.geometry.procedural import standin_for
from tracer_torch.kernels import intersect
from tracer_torch.kernels.intersect import Rays
from tracer_torch.scenes.registry import get_scene

share_cores()

REPO = Path(__file__).resolve().parents[1]
BVH_FIELDS = ("node_min", "node_max", "left", "right", "first", "count", "prim_ids")
MAX_LEAF = 4
W, H = 32, 24


def _bunny_desc(get, traversal: str):
    desc = get("Project: Bunny")
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=W, height=H,
                                                             traversal=traversal))


def _agglom_rays(mesh):
    """``tests/test_accel.py``'s ``_rand_rays(mesh, n=256)``."""
    rs = np.random.RandomState(0)
    lo, hi = mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
    c, ext = (lo + hi) / 2, float(np.max(hi - lo))
    o = c + rs.randn(256, 3).astype(np.float32) * ext
    tgt = c + rs.randn(256, 3).astype(np.float32) * ext * 0.3
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _write_jax_side(out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from tracer.accel import agglom as jax_agglom
    from tracer.accel import lbvh as jax_lbvh
    from tracer.accel import traverse as jax_traverse
    from tracer.geometry.obj import load_obj as jax_load_obj
    from tracer.geometry.procedural import standin_for as jax_standin_for
    from tracer.kernels.intersect import Rays as JaxRays
    from tracer.render import integrator as jax_integrator
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene

    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {"trees": {}, "walks": {}}
    for name in WALK_MESHES:
        mesh = mesh_of(name, jax_load_obj, jax_standin_for)
        tree = jax_lbvh.build(*mesh.bboxes(), max_prims=MAX_LEAF)
        side["trees"][name] = tree
        dev_tree = jax.tree.map(jnp.asarray, tree)
        V, I = jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices)
        rays = JaxRays(*map(jnp.asarray, seeded_rays(mesh.vertices, 2048, 0)))
        t, pid = jax_traverse.bvh_closest_hit(rays, dev_tree, V, I, max_leaf=MAX_LEAF)
        blocked = jax_traverse.bvh_any_hit(rays, dev_tree, V, I, max_leaf=MAX_LEAF)
        side["walks"][name] = dict(t=np.asarray(t), pid=np.asarray(pid),
                                   blocked=np.asarray(blocked))
    mesh = jax_load_obj(str(FIXTURES / "CornellBox.obj"))
    side["agglom"] = jax_agglom.build(*mesh.bboxes(), max_prims=MAX_LEAF)
    scene, cfg = jax_build_scene(_bunny_desc(jax_get_scene, "bvh2"))
    side["bunny_bvh2"] = np.asarray(jax.jit(jax_integrator.render_sample,
                                            static_argnames="cfg")(scene, cfg=cfg))
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_traverse") / "jax_side.pkl"
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": path,
                                         "TRACER_NO_SCENE_CACHE": "1"})
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


def _assert_same_bvh(a, b):
    for f in BVH_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x.view(np.int32), y.view(np.int32)), f


@pytest.mark.parametrize("name", WALK_MESHES)
def test_bvh2_walk_matches_jax(jax_side, name):
    mesh = mesh_of(name, load_obj, standin_for)
    host = lbvh.build(*mesh.bboxes(), max_prims=MAX_LEAF)
    _assert_same_bvh(host, jax_side["trees"][name])
    tree = traverse.to_device(host, "cpu")
    V, I = torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.indices)
    o, d, tmin, tmax = seeded_rays(mesh.vertices, 2048, 0)
    rays = Rays(*map(torch.as_tensor, (o, d, tmin, tmax)))
    t, pid = (x.numpy() for x in traverse.bvh_closest_hit(rays, tree, V, I, max_leaf=MAX_LEAF))
    blocked = traverse.bvh_any_hit(rays, tree, V, I, max_leaf=MAX_LEAF).numpy()
    want = jax_side["walks"][name]
    assert (pid >= 0).sum() > 200 and blocked.sum() > 200 and (~blocked).sum() > 0
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
                if claim >= 0:
                    v0, v1, v2 = mesh.vertices[mesh.indices[claim]]
                    t64, bary = _float64_hit(o[lane], d[lane], v0, v1, v2)
                    assert bary >= -1e-4 and abs(t64 - tt) <= 1e-4 * max(1.0, abs(t64))


def test_agglom_invariants_and_parity(jax_side):
    mesh = load_obj(str(FIXTURES / "CornellBox.obj"))
    lo, hi = mesh.bboxes()
    bvh = agglom.build(lo, hi, max_prims=MAX_LEAF)
    lbvh.validate(bvh, mesh.num_triangles)
    _assert_same_bvh(bvh, jax_side["agglom"])
    o, d = (torch.as_tensor(x) for x in _agglom_rays(mesh))
    rays = intersect.make_rays(o, d)
    V, I = torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.indices)
    _, ids = traverse.bvh_closest_hit(rays, traverse.to_device(bvh, "cpu"), V, I,
                                      max_leaf=MAX_LEAF)
    _, ref = intersect.mesh_brute_force(rays, V, I)
    assert (ref >= 0).sum() > 50
    assert torch.equal(ids, ref.to(ids.dtype))


def test_agglom_singleton():
    lo = np.zeros((1, 3), np.float32)
    hi = np.ones((1, 3), np.float32)
    bvh = agglom.build(lo, hi)
    assert bvh.count[0] == 1
    lbvh.validate(bvh, 1)


def test_bunny_bvh2_frame(jax_side):
    scene_b, cfg_b, walked = _frame(_bunny_desc(get_scene, "bvh2"))
    assert cfg_b.traversal == "bvh2" and scene_b.bvh is not None and scene_b.tb is None
    _, _, treelet = _frame(_bunny_desc(get_scene, "bvh"))
    _assert_close_frac(walked, treelet, 1e-5, 0.995)
    stats = path_stats(jax_side["bunny_bvh2"])
    assert path_errors(path_stats(walked), DIRECT_RTOL, stats) == []


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

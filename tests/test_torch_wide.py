"""The ``bvh8`` engine (``tracer_torch.accel.wide``) against the JAX
package's ``tracer.accel.wide``.

* ``build_table`` over the port's NumPy LBVH of the bunny stand-in and of
  the Cornell box with blocks: the (M, 96) row table bitwise equal to
  ``tracer.accel.wide.build``'s, and the same depth.
* ``closest_hit`` and ``any_hit`` on the seeded rays of
  ``tests/test_torch_bsp.py`` (a quarter with windows that end inside the
  mesh) against the JAX walks on the same table: every lane converged, ids
  and any-hit masks equal and t at rtol 1e-5 (XLA's fused loop rounds the
  leaf test's dot products in its own order), except on disputed lanes
  (the float64 re-test of ``query_borderline``), where each claimed hit is
  re-tested in float64.
* Loud truncation: ``MAX_ITERS`` monkeypatched to 2 clears ``converged`` in
  both queries, and a frame rendered so paints the magenta sentinel
  (``tests/test_accel.py:334-354`` for the JAX package).
* ``Project: Bunny`` with ``traversal="bvh8"`` at 32x24: the frame of the
  treelet engine (allclose at atol 1e-5 on at least 99.5% of the pixels),
  and its statistics meet the JAX package's ``bvh8`` frame at
  ``DIRECT_RTOL``.

The JAX side runs in a child process (``python tests/test_torch_wide.py
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
from test_torch_bsp import WALK_MESHES, _assert_close_frac, _float64_hit, _frame, mesh_of, seeded_rays
from test_torch_direct import query_borderline

from chip_smoke import DIRECT_RTOL, path_errors, path_stats

from tracer_torch.accel import lbvh, wide
from tracer_torch.geometry.obj import load_obj
from tracer_torch.geometry.procedural import standin_for
from tracer_torch.kernels.intersect import Rays
from tracer_torch.render import integrator
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

REPO = Path(__file__).resolve().parents[1]
MAX_LEAF = 4
W, H = 32, 24


def _bunny_desc(get, traversal: str):
    desc = get("Project: Bunny")
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=W, height=H,
                                                             traversal=traversal))


def _write_jax_side(out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from tracer.accel import lbvh as jax_lbvh
    from tracer.accel import wide as jax_wide
    from tracer.geometry.obj import load_obj as jax_load_obj
    from tracer.geometry.procedural import standin_for as jax_standin_for
    from tracer.kernels.intersect import Rays as JaxRays
    from tracer.render import integrator as jax_integrator
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene

    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {"tables": {}, "walks": {}}
    for name in WALK_MESHES:
        mesh = mesh_of(name, jax_load_obj, jax_standin_for)
        wb = jax_wide.build(jax_lbvh.build(*mesh.bboxes(), max_prims=MAX_LEAF), mesh.vertices,
                            mesh.indices)
        side["tables"][name] = (np.asarray(wb.table), wb.depth)
        rays = JaxRays(*map(jnp.asarray, seeded_rays(mesh.vertices, 2048, 0)))
        t, pid, conv = jax_wide.closest_hit(rays, wb, with_conv=True)
        blocked, aconv = jax_wide.any_hit(rays, wb, with_conv=True)
        side["walks"][name] = dict(t=np.asarray(t), pid=np.asarray(pid), conv=np.asarray(conv),
                                   blocked=np.asarray(blocked), aconv=np.asarray(aconv))
    scene, cfg = jax_build_scene(_bunny_desc(jax_get_scene, "bvh8"))
    side["bunny_bvh8"] = np.asarray(jax.jit(jax_integrator.render_sample,
                                            static_argnames="cfg")(scene, cfg=cfg))
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_wide") / "jax_side.pkl"
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": path,
                                         "TRACER_NO_SCENE_CACHE": "1"})
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


def _wide_of(name):
    mesh = mesh_of(name, load_obj, standin_for)
    return mesh, wide.build(lbvh.build(*mesh.bboxes(), max_prims=MAX_LEAF), mesh.vertices,
                            mesh.indices, "cpu")


def _rays(mesh):
    o, d, tmin, tmax = seeded_rays(mesh.vertices, 2048, 0)
    return (o, d, tmin, tmax), Rays(*map(torch.as_tensor, (o, d, tmin, tmax)))


@pytest.mark.parametrize("name", WALK_MESHES)
def test_build_table_matches_jax(jax_side, name):
    mesh = mesh_of(name, load_obj, standin_for)
    table, depth = wide.build_table(lbvh.build(*mesh.bboxes(), max_prims=MAX_LEAF),
                                    mesh.vertices, mesh.indices)
    want, want_depth = jax_side["tables"][name]
    assert table.shape == want.shape and table.shape[1] == wide.ROW and depth == want_depth
    assert np.array_equal(table.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", WALK_MESHES)
def test_walks_match_jax(jax_side, name):
    mesh, wb = _wide_of(name)
    (o, d, tmin, tmax), rays = _rays(mesh)
    t, pid, conv = wide.closest_hit(rays, wb, with_conv=True)
    blocked, aconv = wide.any_hit(rays, wb, with_conv=True)
    t, pid, blocked = t.numpy(), pid.numpy(), blocked.numpy()
    want = jax_side["walks"][name]
    assert conv.all() and aconv.all() and want["conv"].all() and want["aconv"].all()
    assert (pid >= 0).sum() > 200 and blocked.sum() > 200 and (~blocked).sum() > 0
    differ = (pid != want["pid"]) | (blocked != want["blocked"])
    assert differ.mean() <= 0.005, f"{differ.sum()} lanes differ"
    same = ~differ & (pid >= 0)
    # XLA's fused CPU loop rounds the leaf test's three-term dot products
    # apart from the op-by-op order (a few ulps of t); the ids are equal.
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


def test_chunks_do_not_change_the_walk():
    mesh, wb = _wide_of("bunny.obj")
    _, rays = _rays(mesh)
    whole = wide.closest_hit(rays, wb)
    parts = wide.closest_hit(rays, wb, chunk=300)
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))


def test_truncation_is_loud(monkeypatch):
    mesh, wb = _wide_of("bunny.obj")
    _, rays = _rays(mesh)
    monkeypatch.setattr(wide, "MAX_ITERS", 2)
    _, _, conv = wide.closest_hit(rays, wb, with_conv=True)
    _, aconv = wide.any_hit(rays, wb, with_conv=True)
    assert not bool(conv.all()) and not bool(aconv.all())
    scene, cfg = build_scene(_bunny_desc(get_scene, "bvh8"), "cpu")
    img = integrator.render_sample(scene, cfg)
    magenta = (img == torch.tensor(integrator.ERROR_COLOR)).all(dim=-1)
    assert magenta.sum() > 0.1 * W * H


def test_bunny_bvh8_frame(jax_side):
    scene_w, cfg_w, walked = _frame(_bunny_desc(get_scene, "bvh8"))
    assert cfg_w.traversal == "bvh8" and scene_w.wide is not None and scene_w.tb is None
    _, _, treelet = _frame(_bunny_desc(get_scene, "bvh"))
    _assert_close_frac(walked, treelet, 1e-5, 0.995)
    stats = path_stats(jax_side["bunny_bvh8"])
    assert path_errors(path_stats(walked), DIRECT_RTOL, stats) == []


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

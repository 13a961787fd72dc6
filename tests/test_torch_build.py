"""The port's host builders, device assembly, registry and scene builder
against the JAX package, on the same inputs.

Tolerances: the mesh generators, the OBJ loader, both LBVH builders, the
treelet cut, the quarter boxes and the per-triangle table are compared
bitwise (the same NumPy code, or pure gathers and min/max). In the quarter
block table, rows 0-10 and 15 are bitwise too; rows 11-14 (n = cross(e0,
e1) and k = dot(v0, n)) come out at a few float32 ulps of the products
involved, because XLA on the CPU fuses a*b - c*d into fused multiply-adds
while PyTorch rounds every product: they are compared with an absolute
tolerance of 1e-6 times each row's largest magnitude.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from tracer.accel import lbvh as jax_lbvh
from tracer.accel import treelet as jax_treelet
from tracer.geometry import obj as jax_obj
from tracer.geometry import procedural as jax_proc
from tracer.geometry.device import _tri_table as jax_tri_table
from tracer.scenes import registry as jax_registry

import tracer_torch
from tracer_torch.accel import lbvh, native, treelet
from tracer_torch.geometry import obj, procedural
from tracer_torch.geometry.device import _tri_table, upload_mesh
from tracer_torch.scenes import registry
from tracer_torch.scenes.build import build_scene

share_cores()

MESH_FIELDS = ("vertices", "normals", "indices", "mat_ids")
BVH_FIELDS = ("node_min", "node_max", "left", "right", "first", "count",
              "prim_ids")


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.fixture(scope="module")
def bunny():
    return procedural.standin_for("models/bunny.obj")


@pytest.mark.parametrize("name", ["bunny.obj", "dragon.obj"])
def test_standin_mesh_bitwise(name):
    a = jax_proc.standin_for(f"models/{name}")
    b = procedural.standin_for(f"models/{name}")
    for f in MESH_FIELDS:
        assert _same_bits(getattr(a, f), getattr(b, f)), f
    if name == "dragon.obj":
        assert b.num_triangles == 869_880


def test_obj_loader_matches_jax(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nKa 0 0 0\nKs 0.5 0.5 0.5\nNs 20\nillum 2\n"
        "newmtl lamp\nKd 1 1 1\nKa 4 4 4\nillum 1\n"
    )
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\no a\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\nvn 0 1 0\n"
        "usemtl red\nf 1/1/1 2/2/1 3/3/1 4/3/1\ng b\nusemtl lamp\n"
        "f 1//2 2//2 5//2\nf -1 -2 -3\n"
    )
    a = jax_obj.load_obj(str(tmp_path / "m.obj"))
    b = obj.load_obj(str(tmp_path / "m.obj"))
    for f in MESH_FIELDS:
        assert _same_bits(getattr(a, f), getattr(b, f)), f
    assert len(a.materials) == len(b.materials) == 2
    for ma, mb in zip(a.materials, b.materials):
        for f in ("diffuse", "ambient", "specular"):
            assert _same_bits(getattr(ma, f), getattr(mb, f))
        assert (ma.illum, ma.shininess, ma.ior, ma.name) == (
            mb.illum, mb.shininess, mb.ior, mb.name)
    assert _same_bits(a.light_indices(), b.light_indices())
    for x, y in zip(a.bboxes(), b.bboxes()):
        assert _same_bits(x, y)


def test_lbvh_numpy_matches_jax(bunny):
    lo, hi = bunny.bboxes()
    a = jax_lbvh.build(lo, hi, 4)
    b = lbvh.build(lo, hi, 4)
    for f in BVH_FIELDS:
        assert _same_bits(getattr(a, f), getattr(b, f)), f
    lbvh.validate(b, bunny.num_triangles)


@pytest.mark.parametrize("max_prims", [1, 4])
def test_native_lbvh_matches_numpy(bunny, max_prims):
    """The main path's native builder against the port's NumPy builder:
    same primitive order and node count (as tests/test_native.py holds the
    JAX pair)."""
    lo, hi = bunny.bboxes()
    a = lbvh.build(lo, hi, max_prims)
    b = native.build(lo, hi, max_prims)
    lbvh.validate(b, bunny.num_triangles)
    assert a.left.shape[0] == b.left.shape[0]
    assert np.array_equal(a.prim_ids, b.prim_ids)
    assert np.array_equal(a.node_min[0], b.node_min[0])
    assert np.array_equal(a.node_max[0], b.node_max[0])


@pytest.mark.parametrize("T", [32, 1024])
def test_treelet_host_matches_jax(bunny, T):
    lo, hi = bunny.bboxes()
    binary = lbvh.build(lo, hi, 4)
    a = jax_treelet.build_host(binary, T)
    b = treelet.build_host(binary, T)
    for f in ("top", "pids", "counts", "t_lo", "t_hi", "box_table"):
        assert _same_bits(getattr(a, f), getattr(b, f)), f
    assert (a.depth, a.T) == (b.depth, b.T)


def test_assemble_blocks_matches_jax(bunny):
    binary = lbvh.build(*bunny.bboxes(), 4)
    host = treelet.build_host(binary, 1024)
    idx = bunny.indices.astype(np.int32)
    valid = np.arange(host.T)[None, :] < host.counts[:, None]
    _, qbox_j, qblocks_j, _ = jax_treelet.assemble_blocks(
        jnp.asarray(bunny.vertices), jnp.asarray(idx),
        jnp.asarray(host.pids), jnp.asarray(valid),
    )
    tb = treelet.from_host(host, torch.as_tensor(bunny.vertices),
                           torch.as_tensor(idx))
    treelet.validate(tb, bunny.num_triangles)
    assert tb.NT == host.pids.shape[0]
    assert _same_bits(qbox_j, tb.qbox.numpy())
    qa, qb = np.asarray(qblocks_j), tb.qblocks.numpy()
    assert qa.shape == qb.shape == (tb.NT * treelet.NQ, 16, 256)
    exact = [r for r in range(16) if r not in (11, 12, 13, 14)]
    assert _same_bits(qa[:, exact], qb[:, exact])
    for r in (11, 12, 13, 14):
        scale = np.abs(qa[:, r]).max()
        np.testing.assert_allclose(qb[:, r], qa[:, r], rtol=0, atol=1e-6 * scale)


def test_tri_table_and_upload_match_jax(bunny):
    geom, mats, lights = upload_mesh(bunny, "cpu")
    mat = np.zeros(bunny.num_triangles, np.int32)
    ref = jax_tri_table(
        jnp.asarray(bunny.vertices), jnp.asarray(bunny.normals),
        jnp.asarray(bunny.indices.astype(np.int32)), jnp.asarray(mat),
    )
    assert _same_bits(ref, geom.tri_table.numpy())
    assert _same_bits(
        _tri_table(geom.vertices, geom.normals, geom.indices, geom.mat_ids),
        geom.tri_table)
    assert mats.diffuse.shape == (1, 3) and lights.numel() == 0


def test_registry_matches_jax():
    a, b = jax_registry.get_scenes(), registry.get_scenes()
    assert len(a) == len(b) == 44
    for da, db in zip(a, b):
        assert da.name == db.name
        assert dataclasses.asdict(da.cfg) == dataclasses.asdict(db.cfg)
        assert (da.camera, da.spheres, da.planes, da.tris) == (
            db.camera, db.spheres, db.planes, db.tris)
        assert (da.selection1, da.selection2, da.bvh_leaf, da.ref_shader) == (
            db.selection1, db.selection2, db.bvh_leaf, db.ref_shader)
        # Full asset paths: where the reference's assets are mounted, both
        # packages must load the same files.
        assert (da.model, da.hdri, da.hdri_rgbe, da.texture, da.model_scale) == (
            db.model, db.hdri, db.hdri_rgbe, db.texture, db.model_scale)
    assert registry.REF_RES == jax_registry.REF_RES


@pytest.mark.parametrize("name", ["W1 E6", "W8 E3 Absorption",
                                  "W6 E1 Dragon", "W5 E3 Teapot"])
def test_build_scene_rejects_rows_outside_slice(name):
    with pytest.raises(NotImplementedError, match="outside the ported slice"):
        build_scene(registry.get_scene(name), "cpu")


def test_cuda_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tracer_torch.cuda_device()

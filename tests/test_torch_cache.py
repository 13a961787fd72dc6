"""The port's disk cache of scene-build products
(``tracer_torch.scenes.cache``), in a directory of its own per test
(``TRACER_SCENE_CACHE`` under ``tmp_path``).

* A warm build of ``Project: Bunny`` (the mesh and the treelet cut read
  from the cache) equals a cold one bit for bit: the mesh arrays, the
  treelet host arrays, the block table and one 32x24 frame.
* The treelet host read from the cache equals
  ``tracer.accel.treelet.build_host`` of the JAX package's LBVH bitwise.
* ``TRACER_NO_SCENE_CACHE`` writes nothing; a truncated or corrupt entry is
  rebuilt (and rewritten), never an error; the port's entries carry their
  own prefix, so neither package reads the other's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
from _share_cores import share_cores

from tracer.accel import lbvh as jax_lbvh
from tracer.accel import treelet as jax_treelet
from tracer.scenes import cache as jax_cache

from tracer_torch.render import integrator
from tracer_torch.scenes import build, cache
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

HOST_FIELDS = ("top", "pids", "counts", "t_lo", "t_hi", "box_table")
MESH_FIELDS = ("vertices", "normals", "indices", "mat_ids")


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "scene-cache"
    monkeypatch.setenv("TRACER_SCENE_CACHE", str(d))
    monkeypatch.delenv("TRACER_NO_SCENE_CACHE", raising=False)
    return d


def _bunny():
    desc = get_scene("Project: Bunny")
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=32, height=24))


def _host_of(desc):
    mesh = build.load_mesh(desc.model, desc.model_scale)
    return mesh, build.treelet_host(mesh, desc.bvh_leaf)


def test_warm_build_equals_cold(cache_dir):
    desc = _bunny()
    mesh0, host0 = _host_of(desc)
    entries = sorted(os.listdir(cache_dir))
    assert len(entries) == 2 and all(e.startswith(cache.PREFIX) for e in entries)
    mesh1, host1 = _host_of(desc)  # read back from the files
    assert mesh1 is not mesh0 and host1 is not host0
    for k in MESH_FIELDS:
        assert _same_bits(getattr(mesh0, k), getattr(mesh1, k)), k
    for k in HOST_FIELDS:
        assert _same_bits(getattr(host0, k), getattr(host1, k)), k
    assert (host0.depth, host0.T) == (host1.depth, host1.T)

    os.environ["TRACER_NO_SCENE_CACHE"] = "1"
    try:
        cold, cfg = build_scene(desc, "cpu")
    finally:
        del os.environ["TRACER_NO_SCENE_CACHE"]
    timings: dict = {}
    warm, _ = build_scene(desc, "cpu", timings=timings)
    assert set(timings) >= {"mesh_load", "accel_host", "upload", "device_assembly", "total"}
    for k in ("qblocks", "qbox", "top", "t_lo", "t_hi"):
        assert _same_bits(getattr(cold.tb, k).numpy(), getattr(warm.tb, k).numpy()), k
    a = integrator.render_sample(cold, cfg)
    b = integrator.render_sample(warm, cfg)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(a.abs().sum()) > 0


def test_cached_host_equals_jax_build_host(cache_dir):
    desc = _bunny()
    mesh, _ = _host_of(desc)
    host = cache.load_treelet_host(cache.mesh_fingerprint(mesh), desc.bvh_leaf, build.TREELET_T)
    assert host is not None
    want = jax_treelet.build_host(jax_lbvh.build_for_mesh(mesh, max_prims=desc.bvh_leaf),
                                  T=build.TREELET_T)
    for k in HOST_FIELDS:
        assert _same_bits(getattr(host, k), getattr(want, k)), k
    assert (host.depth, host.T) == (want.depth, want.T)
    assert cache.mesh_fingerprint(mesh) == jax_cache.mesh_fingerprint(mesh)


def test_packages_keep_apart(cache_dir, monkeypatch):
    """The JAX package's entries in the same directory are never read by
    the port, nor the port's by it."""
    desc = _bunny()
    mesh, host = _host_of(desc)
    fp = cache.mesh_fingerprint(mesh)
    ours = set(os.listdir(cache_dir))
    assert jax_cache.load_treelet_host(fp, desc.bvh_leaf, build.TREELET_T) is None
    assert jax_cache.load_mesh(desc.model, desc.model_scale) is None
    jax_cache.save_treelet_host(fp, desc.bvh_leaf, host)
    theirs = set(os.listdir(cache_dir)) - ours
    assert len(theirs) == 1 and not next(iter(theirs)).startswith(cache.PREFIX)
    for name in ours:
        os.unlink(cache_dir / name)
    assert cache.load_treelet_host(fp, desc.bvh_leaf, build.TREELET_T) is None


def test_no_cache_writes_nothing(cache_dir, monkeypatch):
    monkeypatch.setenv("TRACER_NO_SCENE_CACHE", "1")
    _host_of(_bunny())
    assert not cache_dir.exists() or os.listdir(cache_dir) == []


@pytest.mark.parametrize("damage", ["truncated", "garbage", "empty"])
def test_damaged_entry_rebuilds(cache_dir, damage):
    desc = _bunny()
    mesh0, host0 = _host_of(desc)
    for name in os.listdir(cache_dir):
        path = cache_dir / name
        data = path.read_bytes()
        path.write_bytes({"truncated": data[:len(data) // 3], "garbage": b"\x00" * 999,
                          "empty": b""}[damage])
    fp = cache.mesh_fingerprint(mesh0)
    assert cache.load_mesh(desc.model, desc.model_scale) is None
    assert cache.load_treelet_host(fp, desc.bvh_leaf, build.TREELET_T) is None
    mesh1, host1 = _host_of(desc)  # rebuilt and rewritten
    for k in HOST_FIELDS:
        assert _same_bits(getattr(host0, k), getattr(host1, k)), k
    assert _same_bits(mesh0.vertices, mesh1.vertices)
    assert cache.load_treelet_host(fp, desc.bvh_leaf, build.TREELET_T) is not None
    assert cache.load_mesh(desc.model, desc.model_scale) is not None

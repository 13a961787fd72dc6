"""The hand-written Cornell boxes of ``tests/fixtures`` (``CornellBox.obj``
and ``CornellBoxWithBlocks.obj`` with their ``.mtl``), which stand in for
the reference's models of the same names: both packages' OBJ loaders read
them to equal arrays (bit for bit), ``CornellBox.obj`` meets every
assertion ``tests/test_geometry.py`` makes of the real file, every face
normal points into the room, and both packages route the rows that use
them to the brute-force engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from _share_cores import share_cores

from chip_smoke import FIXTURES, FIXTURE_MODELS, with_fixture_model
from tracer.geometry import obj as jax_obj
from tracer.scenes import build_scene as jax_build_scene
from tracer.scenes import get_scene as jax_get_scene

from tracer_torch.geometry import obj
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

LOADERS = {"jax": jax_obj.load_obj, "port": obj.load_obj}
CEILING_Y, LIGHT_Y = 548.8, 548.3
ROOM_CENTER = np.array([278.0, 274.4, 279.6])
# Triangle ids of each part, in the files' order: floor, ceiling, back,
# left (red) and right (green) walls, light, then the two blocks.
ROOM, LIGHT = range(0, 10), range(10, 12)
BLOCKS = {range(12, 22): np.array([186.0, 82.5, 168.5]),  # short block's centre
          range(22, 32): np.array([368.5, 165.0, 351.25])}  # tall block's centre


def _load(name, loader="port"):
    return LOADERS[loader](str(FIXTURES / name))


@pytest.mark.parametrize("name", FIXTURE_MODELS)
def test_both_loaders_read_the_same_arrays(name):
    a, b = _load(name, "jax"), _load(name, "port")
    for key in ("vertices", "normals", "indices", "mat_ids"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        assert (ma.name, ma.illum, ma.shininess, ma.ior) == (mb.name, mb.illum, mb.shininess,
                                                             mb.ior)
        for key in ("diffuse", "ambient", "specular"):
            assert np.array_equal(getattr(ma, key), getattr(mb, key)), (ma.name, key)
    assert np.array_equal(a.light_indices(), b.light_indices())


@pytest.mark.parametrize("loader", LOADERS)
def test_cornell_box_meets_the_geometry_tests(loader):
    """``tests/test_geometry.py``'s assertions on the reference's
    CornellBox.obj (``test_cornell_load``,
    ``test_cornell_no_normals_zero_filled``, ``test_indices_in_range``,
    ``test_scale``), held here against the fixture."""
    m = _load("CornellBox.obj", loader)
    assert m.num_triangles == 12
    assert len(m.materials) == 4
    names = [mat.name for mat in m.materials]
    assert "light" in names
    light_mat = m.materials[names.index("light")]
    assert light_mat.illum == 1
    assert np.allclose(light_mat.ambient, [27.6, 23.4, 12.0], atol=1e-5)
    lights = m.light_indices()
    assert len(lights) == 2
    assert all(m.materials[m.mat_ids[i]].illum == 1 for i in lights)
    assert np.all(m.normals == 0.0)
    assert m.indices.max() < m.num_vertices
    assert (m.mat_ids < len(m.materials)).all()
    s = m.scale(1.0 / 500.0)
    assert np.allclose(s.vertices, m.vertices / 500.0)
    assert sorted(names) == ["green", "light", "red", "white"]


def test_blocks_fit_the_brute_force_engine():
    m = _load("CornellBoxWithBlocks.obj")
    assert m.num_triangles == 32 <= 64
    assert [mat.name for mat in m.materials] == ["white", "red", "green", "light"]
    assert m.light_indices().tolist() == [10, 11]
    assert np.all(m.normals == 0.0)
    white = [mat.name for mat in m.materials].index("white")
    assert (m.mat_ids[12:] == white).all()
    box = _load("CornellBox.obj")
    assert np.array_equal(m.vertices[:24], box.vertices) and np.array_equal(
        m.indices[:12], box.indices)


@pytest.mark.parametrize("name", FIXTURE_MODELS)
def test_face_normals_point_into_the_room(name):
    """cross(v1 - v0, v2 - v0) of every triangle: toward the room's centre
    for the floor, ceiling and walls, straight down for the light (which
    hangs below the ceiling, inside the box), and away from its block for
    each block face."""
    m = _load(name)
    v0, v1, v2 = (x.astype(np.float64) for x in m.triangle_vertices())
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    centroid = (v0 + v1 + v2) / 3.0
    assert m.light_indices().tolist() == list(LIGHT)
    for i in ROOM:
        assert n[i] @ (ROOM_CENTER - centroid[i]) > 0, i
    for i in LIGHT:
        assert np.allclose(n[i], [0.0, -1.0, 0.0]), i
        assert np.all(np.stack([v0[i], v1[i], v2[i]])[:, 1] == np.float32(LIGHT_Y))
        assert LIGHT_Y < CEILING_Y
    blocks = BLOCKS if m.num_triangles == 32 else {}
    for ids, centre in blocks.items():
        for i in ids:
            assert n[i] @ (centroid[i] - centre) > 0, i


@pytest.mark.parametrize("row", ["W8 E3 Absorption", "W7 E3 Cornell Box"])
def test_both_packages_route_the_rows_to_brute_force(row):
    jdesc, desc = with_fixture_model(jax_get_scene(row)), with_fixture_model(get_scene(row))
    assert jdesc.model == desc.model == str(FIXTURES / jax_get_scene(row).model.split("/")[-1])
    small = lambda d: dataclasses.replace(d, cfg=dataclasses.replace(d.cfg, width=8, height=8))
    jscene, jcfg = jax_build_scene(small(jdesc))
    scene, cfg = build_scene(small(desc), "cpu")
    assert jdesc.cfg.traversal == "bsp"
    assert jcfg.traversal == cfg.traversal == "brute"
    assert jscene.tb is None and scene.tb is None


def test_with_fixture_model_raises_for_other_missing_models():
    with pytest.raises(FileNotFoundError, match="no fixture"):
        with_fixture_model(get_scene("W9 E3 Teapot"))

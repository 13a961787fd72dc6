"""A configuration on a model file of the repository (``obj``): the
frozen parse (``reference/objfile.py``) against the program's loader,
``W8 E3 Absorption`` on the frozen Cornell box built through
``harness.build`` and rendered by the frame loop, and the faults the
build's checks and ``mesh_differs`` must catch."""

import copy
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, inputs as inp
from benchmark.reference import objfile
from benchmark.tests.tiny import ROOT

CONFIG = json.loads((ROOT / "benchmark" / "tests" / "w8e3_absorption.json").read_text())
FIXTURES = ROOT / "tests" / "fixtures"
SEED = 2_800_000_011


def cornell_cell(size: int = 16) -> harness.Cell:
    """The W8 E3 configuration at ``size`` x ``size`` as a cell of the frame
    loop, whose check samples 256 lanes."""
    conf = dict(copy.deepcopy(CONFIG), width=size, height=size)
    return harness.Cell("cornell_path.frames", conf, {"loop": "frames", "check": {"lanes": 256}},
                        [], [])


def build(c: harness.Cell, monkeypatch):
    monkeypatch.setenv("TRACER_NO_SCENE_CACHE", "1")
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    return harness.build(c, inp.seeded(c.config, SEED), torch.device("cpu"), {})


def program_view(mesh):
    """What ``mesh_differs`` reads of a scene, from the program's upload of
    its loader's ``mesh`` (``MeshData``)."""
    from tracer_torch.geometry.device import upload_mesh

    geom, materials, lights = upload_mesh(mesh, "cpu")
    return SimpleNamespace(geom=geom, materials=materials, light_indices=lights)


@pytest.mark.parametrize("path,scale", [
    (ROOT / CONFIG["obj"]["file"], 1.0), (FIXTURES / "CornellBox.obj", 1.0),
    (FIXTURES / "CornellBoxWithBlocks.obj", 1.0), (FIXTURES / "CornellBoxWithBlocks.obj", 0.37)],
    ids=["assets-box", "fixture-box", "fixture-blocks", "fixture-blocks-scaled"])
def test_objfile_matches_the_program_bit_for_bit(path, scale):
    from tracer_torch.geometry.obj import load_obj

    prog = load_obj(str(path))
    if scale != 1.0:
        prog = prog.scale(scale)
    V, Nv, I, mat_ids, materials = objfile.load_obj(path)
    assert np.array_equal(mat_ids, prog.mat_ids)
    for mine, theirs in zip(materials, prog.materials, strict=True):
        for k in ("diffuse", "ambient", "illum"):
            assert np.array_equal(mine[k], getattr(theirs, k)), k
    mesh = objfile.load(path, scale)
    assert harness.mesh_differs(program_view(prog), mesh) == 0.0
    assert np.array_equal(np.flatnonzero(mesh.light), prog.light_indices())
    assert mesh.light.any() and mesh.emission[mesh.light].min() > 0
    if path.name == "CornellBox.obj":
        assert mesh.I.shape == (12, 3) and mesh.light.sum() == 2


def test_obj_configuration_builds_and_renders(monkeypatch):
    c = cornell_cell()
    scene, cfg = build(c, monkeypatch)
    assert cfg.traversal == "brute" and scene.tb is None
    assert scene.spheres is not None and scene.spheres.radius.shape == (2,)
    mesh = harness.reference_mesh(c.config)
    assert isinstance(mesh, objfile.Mesh) and mesh.spheres == CONFIG["spheres"]
    assert mesh.planes == [] and mesh.tris == []
    assert harness.mesh_differs(scene, mesh) == 0.0
    inputs = inp.seeded(c.config, SEED)
    unit_fn, output = c.loop.prepare(c, inputs, scene, cfg, torch.device("cpu"), harness.sync)
    for _ in range(2):
        unit_fn()
    accum, own = output(SEED, 2)
    assert own == {"frames_missing": 0.0}
    assert accum.shape == (128, 3) and torch.isfinite(accum).all() and (accum >= 0).all()
    assert accum.max() > 0


def test_stand_in_configurations_keep_their_mesh():
    for name in ("dragon", "bunny_path"):
        conf = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
        mesh = harness.reference_mesh(dict(conf, standin=dict(conf["standin"], n_lat=6,
                                                               n_lon=8)))
        assert type(mesh) is tuple and len(mesh) == 3
        # The shading check compares what the file states: the same 12 keys as before.
        assert set(conf["scene"]) == {
            "mode", "max_depth", "eta", "tmax", "bg_color", "lights", "dir_light_direction",
            "dir_light_intensity", "shadows", "ambient", "use_vertex_normals", "env_light"}
        assert not any(k in conf for k in harness.PRIMITIVES)


def _flip_vertex_bit(monkeypatch):
    from tracer_torch.scenes import build as B

    orig = B.load_mesh

    def flipped(path, scale=1.0):
        m = orig(path, scale)
        v = m.vertices.copy()
        v.view(np.uint32)[3, 1] ^= 1
        return dataclasses.replace(m, vertices=v)

    monkeypatch.setattr(B, "load_mesh", flipped)


def _drop_light_flag(monkeypatch):
    from tracer_torch.geometry import obj

    orig = obj.load_mtl

    def dropped(path):
        out = orig(path)
        for m in out.values():
            if m.illum == 1:
                m.illum = 2
        return out

    monkeypatch.setattr(obj, "load_mtl", dropped)


@pytest.mark.parametrize("fault", [_flip_vertex_bit, _drop_light_flag],
                         ids=["vertex-bit", "light-flag"])
def test_planted_mesh_fault_sets_mesh_differs(fault, monkeypatch):
    c = cornell_cell(8)
    fault(monkeypatch)
    scene, _ = build(c, monkeypatch)
    assert harness.mesh_differs(scene, harness.reference_mesh(c.config)) == 1.0


def _sphere_radius(conf):
    conf["spheres"][1][1] = 91.0


def _firefly_clamp(conf):
    conf["scene"]["firefly_clamp"] = 50.0


def _spheres_unstated(conf):
    del conf["spheres"]


def _scale(conf):
    conf["obj"]["scale"] = 2.0


def _unknown_setting(conf):
    conf["scene"]["absorption"] = True


@pytest.mark.parametrize("change", [_sphere_radius, _firefly_clamp, _spheres_unstated, _scale,
                                    _unknown_setting],
                         ids=["sphere-radius", "firefly-clamp", "spheres-unstated", "scale",
                              "unknown-setting"])
def test_build_refuses_a_configuration_the_row_does_not_match(change, monkeypatch):
    c = cornell_cell(8)
    change(c.config)
    with pytest.raises(ValueError):
        build(c, monkeypatch)


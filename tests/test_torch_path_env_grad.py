"""The W9 E1 path gradient against the benchmark's plain reference
(``benchmark/reference/path_env_grad.py``), on the CPU at 16x16 and the
row's depth 50.

The program's side is its normal path: ``diff.grad.grad_scene`` on the
``W9 E1 Bunny`` row (path mode, the ``scan`` loop, the packet engine with
B3's twin forward, ``fetch_tri_rows`` and B2's twin backward), lit by the
seeded environment (``benchmark/reference/env.py``), against a seeded
uniform target. The mesh is a bowl of 176 triangles: the back half of a
lat-long sphere at the bunny's place, its vertex normals turned inward, its
opening toward the camera. It is concave, so continued paths hit it again,
and gradients reach a hit's position through the segments that leave it;
the bunny's stand-in with outward normals sends nearly every continuation
to the sky at this size. More than 128 triangles, so rows are fetched by
``fetch_tri_rows`` and placed by B2, not by the one-hot product.

* Leaf by leaf, the relative error of each leaf's gradient (norm of the
  difference over the reference's norm, ``compare.grad_numbers``) is under
  ``TOL`` = 1e-4. The two sides round differently (the program multiplies
  by a reciprocal where the reference divides, sums a pixel's bounces and
  the frame's loss in another order, and its B2 twin sums each vertex's
  rows in chunks), which reads at most 2.7e-6 here; the weakest planted
  fault, a tenth added to one leaf, reads 0.1.
* Each planted fault of ``benchmark/tests/path_grad_faults.py`` and the
  generic gradient faults of ``benchmark/tests/faults.py`` fail that
  comparison.
* Spans on and off give the same gradient bit for bit; ``grad.place``
  opens once a fetched bounce; ``scatter_vn.rows`` and
  ``scatter_vn.out_rows`` equal the rows B2 placed and the rows of the
  tables it wrote; ``texel_place.rows`` and ``texel_place.out_rows`` count
  each bounce's environment lookup, 4 taps a lane, into the map's texels;
  ``grad.held_bytes`` is 0 on the CPU and positive on the card.
* ``render_mean``'s divisor made once (``vec.div``) gives the gradient of
  the division by a fresh ``torch.tensor`` bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _share_cores import share_cores

from benchmark.reference import compare, env as ref_env, path_env_grad, standin
from benchmark.tests import faults, path_grad_faults
from tracer_torch import obs
from tracer_torch.diff import grad as G
from tracer_torch.geometry.obj import MaterialData, MeshData
from tracer_torch.kernels import scatter_vn, texel_place
from tracer_torch.render import texture
from tracer_torch.scenes import build as build_mod
from tracer_torch.scenes.registry import get_scene

share_cores()

SIZE = 16
TOL = 1e-4
ENV_SEED, TARGET_SEED = 2_900_000_017, 2_900_000_019
MODELLED = ("camera.eye", "camera.target", "camera.up", "camera.constant", "camera.aspect",
            "geom.vertices", "geom.normals", "materials.diffuse", "materials.emission",
            "env.data")


def bowl(n_lat: int = 12, n_lon: int = 16, radius: float = 0.07,
         center=(-0.02, 0.11, 0.0)):
    """(V, Nv, I) of the back half (z < 0 about ``center``) of a lat-long
    sphere, vertex normals pointing into it."""
    verts, pts, faces = standin.uv_sphere(n_lat, n_lon, radius, center)
    back = pts[faces.astype(np.int64)].mean(axis=1)[:, 2] < 0.0
    return verts, (-pts).astype(np.float32), np.ascontiguousarray(faces[back])


@pytest.fixture(scope="module")
def case():
    """(scene, cfg, target, reference inputs) of W9 E1 on the bowl at
    16x16, the seeded environment and target."""
    V, Nv, I = bowl()
    mat = MaterialData.default()
    mesh = MeshData(vertices=V, normals=Nv, indices=I, mat_ids=np.zeros(I.shape[0], np.uint32),
                    materials=[mat])
    desc = get_scene("W9 E1 Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=SIZE, height=SIZE,
                                                             loop="scan"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRACER_NO_SCENE_CACHE", "1")
        mp.setattr(build_mod, "standin_for", lambda path: mesh)
        scene, cfg = build_mod.build_scene(desc, "cpu")
    assert scene.geom.indices.shape[0] == 176 and scene.tb is not None
    env = torch.as_tensor(ref_env.seeded_env(False, ENV_SEED, (32, 64)))
    scene = dataclasses.replace(scene, env=texture.TextureBuf(data=env, kind=texture.ENV_LDR))
    target = torch.rand((SIZE * SIZE, 3), generator=torch.Generator().manual_seed(TARGET_SEED))
    material = {"diffuse": mat.diffuse.tolist(), "emission": mat.ambient.tolist(),
                "specular": mat.specular.tolist(), "shininess": mat.shininess, "ior": mat.ior}
    sc = {"mode": cfg.mode, "lights": list(cfg.lights), "env_light": cfg.env_light,
          "use_vertex_normals": cfg.use_vertex_normals, "eta": cfg.eta, "tmax": cfg.tmax,
          "max_depth": cfg.max_depth}
    ref = path_env_grad.gradient(sc, dict(desc.camera), SIZE, SIZE, env,
                                 tuple(torch.as_tensor(x) for x in (V, Nv, I)), material, target)
    return scene, cfg, target, ref


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    obs.enabled(False)
    yield
    obs.enabled(False)
    obs.reset()


def _program(scene, cfg, target, num_samples: int = 1) -> dict:
    g = G.grad_scene(scene, cfg, target, num_samples)
    return {k: G.leaf(g, k).detach().clone() for k in G.float_leaves(scene)}


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_program_matches_the_reference_leaf_by_leaf(case):
    scene, cfg, target, ref = case
    assert cfg.max_depth == 50 and cfg.mode == "path"
    leaves: dict = {}
    compare.grad_numbers(_program(scene, cfg, target), ref, leaves)
    assert all(leaves[k]["norm"] > 0 for k in MODELLED), leaves
    worst = {k: v["err"] for k, v in leaves.items() if v["err"] > TOL}
    assert not worst, worst
    # Paths bounce inside the bowl: more than two bounces, B2 every bounce.
    assert obs.counters()["integrator.bounces"] > 2


FAULTS = path_grad_faults.PATH_GRAD + faults.GRAD


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_fails_the_comparison(case, fault, monkeypatch):
    scene, cfg, target, ref = case
    fault(monkeypatch.setattr)
    got = compare.grad_numbers(_program(scene, cfg, target), ref)["grad_err"]
    assert got > TOL, (fault.__name__, got)


def test_gradient_bitwise_with_spans_on_and_off(case):
    scene, cfg, target, _ = case
    off = _program(scene, cfg, target)
    obs.reset()
    obs.enabled(True)
    calls = scatter_vn.REFERENCE_CALLS
    on = _program(scene, cfg, target)
    for k in off:
        assert torch.equal(_bits(off[k]), _bits(on[k])), k
    # One placement a fetch that the loss reaches: every bounce's but the
    # last one's, whose hits all end there.
    assert obs.totals()["grad.place"].calls == scatter_vn.REFERENCE_CALLS - calls \
        == obs.counters()["integrator.bounces"] - 1


def test_scatter_vn_counters_equal_the_rows_placed(case, monkeypatch):
    scene, cfg, target, _ = case
    placed = {"rows": 0, "out_rows": 0, "calls": 0}
    twin = scatter_vn.segment_place_reference

    def spy(sids, svals, V):
        placed["rows"] += sids.shape[0]
        placed["out_rows"] += V
        placed["calls"] += 1
        return twin(sids, svals, V)

    monkeypatch.setattr(scatter_vn, "segment_place_reference", spy)
    _program(scene, cfg, target)
    c = obs.counters()
    assert placed["calls"] == c["integrator.bounces"] - 1 > 0
    # Every lane's three corners a placement; the bowl's sphere has 208 vertices.
    assert c["scatter_vn.rows"] == placed["rows"] == 3 * SIZE * SIZE * placed["calls"]
    assert c["scatter_vn.out_rows"] == placed["out_rows"] == 208 * placed["calls"]


def test_texel_place_counters_equal_the_lookups(case):
    """Every bounce looks up the environment for every lane: one placement
    of 4 taps x SIZE^2 lanes into the 32x64 map's texels a bounce. B2's
    counters count vertex corners alone."""
    scene, cfg, target, _ = case
    calls = texel_place.REFERENCE_CALLS
    _program(scene, cfg, target)
    c = obs.counters()
    bounces = c["integrator.bounces"]
    assert texel_place.REFERENCE_CALLS - calls == bounces > 2
    assert c["texel_place.rows"] == 4 * SIZE * SIZE * bounces
    assert c["texel_place.out_rows"] == 32 * 64 * bounces
    assert c["scatter_vn.rows"] == 3 * SIZE * SIZE * (bounces - 1)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_held_bytes_on_the_card_only(device, case):
    scene, cfg, target, _ = case
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (the allocator's counters are the card's)")
        desc = get_scene("W9 E1 Bunny")
        desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=SIZE,
                                                                 height=SIZE, loop="scan"))
        scene, cfg = build_mod.build_scene(desc, device)
        env = torch.as_tensor(ref_env.seeded_env(False, ENV_SEED, (32, 64)), device=device)
        scene = dataclasses.replace(scene, env=texture.TextureBuf(data=env,
                                                                  kind=texture.ENV_LDR))
        target = target.to(device)
    G.grad_scene(scene, cfg, target)
    held = obs.counters()["grad.held_bytes"]
    if device == "cpu":
        assert held == 0
    else:
        assert held > 0


def _division_render_mean(scene, cfg, num_samples: int = 1):
    """``render_mean`` as it divided before: by a fresh ``torch.tensor``."""
    acc = torch.zeros((G.integrator.lanes(scene, cfg), 3), dtype=torch.float32,
                      device=scene.device)
    for it in range(num_samples):
        acc = acc + G.render_radiance(scene, cfg, it)
    return acc / torch.tensor(float(num_samples), device=scene.device)


@pytest.mark.parametrize("num_samples", [1, 2])
def test_render_mean_divisor_made_once_is_bitwise(case, num_samples, monkeypatch):
    scene, cfg, target, _ = case
    now = _program(scene, cfg, target, num_samples)
    monkeypatch.setattr(G, "render_mean", _division_render_mean)
    before = _program(scene, cfg, target, num_samples)
    for k in now:
        assert torch.equal(_bits(now[k]), _bits(before[k])), k

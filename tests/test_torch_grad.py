"""The gradient slice as a whole: ``grad_scene`` on ``Project: Bunny`` (the
procedural stand-in, 69k triangles) at 64x48, with target zeros, one
sample, ``loop="scan"`` and ``max_depth=2`` (as the JAX package's
``bench.py`` runs the gradient step), against the JAX package on the very
same buffers (``convert.scene_from_arrays``).

Tolerances:
* Masked comparison, leaf by leaf: lanes whose hit ids differ between the
  two packages are left out of a hand-written L2 over ``render_radiance``
  on both sides, so what remains differs by rounding alone (XLA contracts
  multiply-adds into FMAs and sums the lanes and corners in other orders).
  Each leaf agrees at rtol 3e-4 with an atol of 1e-4 of the leaf's largest
  magnitude. Most elements agree to ~1e-6; the few vertices that only a
  near-grazing lane reaches differ by up to 1.4e-4 relative, because the
  re-derived t = (v0 - o).n / (d.n) amplifies the rounding there, and
  per-vertex sums of mixed signs cancel.
* Unmasked ``grad_scene``: the camera and material leaves at rtol 1e-3,
  the order of the id flips at silhouettes (none on these buffers today).
* Two runs of the port: bitwise. ``fd_check`` on the diffuse albedo (the
  loss is quadratic in it: rtol 1e-3) and on a rigid z-translation of the
  vertices (eps 1e-3 of the mesh's extent, rtol 0.25 as in
  ``tests/test_grad.py``; silhouettes move).

The JAX side runs in a child process (``python tests/test_torch_grad.py
OUT``): in this JAX version, a jitted render in a process makes a later
second ``tracer.render.progressive.step`` on the same scene row fail
("Execution supplied 25 buffers but compiled program expected 30"), and
pytest-xdist may run other modules that step after this one in the same
worker.
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

from chip_smoke import (BUNNY_GRAD_REF, BUNNY_GRAD_ZERO, bunny_grad_errors,
                        grad_stats)
from tracer.accel import flat as jax_flat
from tracer.diff import grad as JG
from tracer.kernels.intersect import Rays as JaxRays
from tracer.render import camera as jax_camera
from tracer.scenes import build_scene as jax_build_scene
from tracer.scenes import get_scene as jax_get_scene

from tracer_torch import convert
from tracer_torch.accel import flat
from tracer_torch.diff import grad as G
from tracer_torch.geometry.device import refresh_tri_table
from tracer_torch.render import integrator
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

W, H = 64, 48
REPO = Path(__file__).resolve().parents[1]


def _small(desc, w=W, h=H):
    return dataclasses.replace(desc, cfg=dataclasses.replace(
        desc.cfg, width=w, height=h, loop="scan", max_depth=2))


def _port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(SceneConfig)})


def _port_ids(scene, cfg):
    rays = integrator.primary_rays(scene, cfg)
    return flat.closest_hit(rays, scene.tb, frame=(W, H))[1].numpy()


def _write_jax_side(out: Path) -> None:
    """The JAX package on the bunny: its scene's buffers and config, its
    ``grad_scene``, its primary hit ids, the mask of lanes whose ids the
    port (on the same buffers) agrees with, and the gradient of the L2 over
    those lanes alone. Pickled to ``out``."""
    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    scene, cfg = jax_build_scene(_small(jax_get_scene("Project: Bunny")))
    grads = convert.grads_to_arrays(JG.grad_scene(scene, cfg, jnp.zeros((W * H, 3), jnp.float32)))
    u, v = jax_camera.pixel_uv(W, H)
    r = jax_camera.camera_rays(scene.camera, u, v)
    rays = JaxRays(r.o, r.d, np.full(W * H, cfg.eta, np.float32),
                   np.full(W * H, cfg.tmax, np.float32))
    _, ids = jax.jit(jax_flat.closest_hit, static_argnames=("frame",))(
        rays, scene.tb, frame=(W, H))
    arrays = jax.tree.map(np.asarray, scene)
    mask = (_port_ids(convert.scene_from_arrays(arrays, "cpu"), _port_cfg(cfg))
            == np.asarray(ids)).astype(np.float32)

    def mloss(s):
        img = JG.render_radiance(s, cfg)
        return jnp.sum(jnp.asarray(mask)[:, None] * img ** 2) / img.size

    masked = convert.grads_to_arrays(jax.jit(jax.grad(mloss, allow_int=True))(scene))
    with open(out, "wb") as f:
        pickle.dump(dict(scene=arrays, cfg=cfg, grads=grads, ids=np.asarray(ids),
                         mask=mask, masked=masked), f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_side") / "jax_side.pkl"
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": path})
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The port on the JAX scene's buffers: its ``grad_scene`` and its
    primary hit ids."""
    scene = convert.scene_from_arrays(jax_side["scene"], "cpu")
    cfg = _port_cfg(jax_side["cfg"])
    g = G.grad_scene(scene, cfg, torch.zeros((W * H, 3)))
    return scene, cfg, g, _port_ids(scene, cfg)


def test_traversal_carries_no_gradient(port_side, monkeypatch):
    """With the camera eye requiring grad, the traversal sees detached
    inputs, runs without a graph and returns ids and t without grad; the
    radiance is bitwise the one rendered with grad off."""
    scene, cfg = port_side[0], port_side[1]
    cfg = dataclasses.replace(cfg, width=32, height=24)
    seen = []
    closest_hit = flat.closest_hit

    def spy(rays, *a, **k):
        out = closest_hit(rays, *a, **k)
        seen.append((torch.is_grad_enabled(), rays, out))
        return out

    monkeypatch.setattr(integrator.flat, "closest_hit", spy)
    with torch.no_grad():
        plain = integrator.render_sample(scene, cfg)
    eye = scene.camera.eye.detach().clone().requires_grad_()
    scene_g = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, eye=eye))
    with torch.enable_grad():
        rad = integrator.render_sample(scene_g, cfg)
    assert rad.requires_grad
    grad_on, rays, (t, ids, conv) = seen[-1]
    assert not grad_on
    assert not any(x.requires_grad for x in (rays.o, rays.d, rays.tmin, rays.tmax))
    assert not t.requires_grad and not ids.requires_grad and not conv.requires_grad
    assert torch.equal(rad.detach().view(torch.int32), plain.view(torch.int32))


def _masked_grads_port(scene, cfg, mask):
    leaves = {k: G.leaf(scene, k).detach().requires_grad_(k != "geom.tri_table")
              for k in G.FLOAT_LEAVES}
    with torch.enable_grad():
        img = G.render_radiance(G.with_leaves(scene, leaves), cfg)
        loss = (torch.as_tensor(mask)[:, None] * img ** 2).sum() / img.numel()
        wrt = [k for k in G.FLOAT_LEAVES if leaves[k].requires_grad]
        grads = torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)
    out = {k: np.zeros(leaves[k].shape, np.float32) for k in G.FLOAT_LEAVES}
    out |= {k: g.numpy() for k, g in zip(wrt, grads) if g is not None}
    return out


def test_grad_matches_jax_leaf_by_leaf(jax_side, port_side):
    scene, cfg, g, ids = port_side
    same = ids == jax_side["ids"]
    assert same.mean() >= 0.995 and (ids >= 0).sum() > 1000
    assert np.array_equal(same, jax_side["mask"] > 0)
    want = jax_side["masked"]
    got = _masked_grads_port(scene, cfg, jax_side["mask"])
    for k in G.FLOAT_LEAVES:
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=3e-4, atol=1e-4 * scale, err_msg=k)
    for k in ("geom.vertices", "geom.normals", "materials.diffuse", "camera.eye"):
        assert np.abs(got[k]).sum() > 0, k

    # Unmasked, through grad_scene: the global leaves.
    ga, jg = convert.grads_to_arrays(g), jax_side["grads"]
    for k in ("camera.eye", "camera.target", "camera.up", "camera.constant",
              "camera.aspect", "materials.diffuse", "materials.emission"):
        np.testing.assert_allclose(ga[k], jg[k], rtol=1e-3, err_msg=k)
    for k in BUNNY_GRAD_ZERO + ("materials.shininess", "materials.ior"):
        assert not ga[k].any() and not jg[k].any(), k


def test_two_runs_bitwise(port_side):
    scene, cfg, g, _ = port_side
    a = convert.grads_to_arrays(g)
    b = convert.grads_to_arrays(G.grad_scene(scene, cfg, torch.zeros((W * H, 3))))
    for k in G.FLOAT_LEAVES:
        assert np.array_equal(a[k].view(np.int32), b[k].view(np.int32)), k


def test_fd_check_diffuse(port_side):
    scene, cfg = port_side[0], port_side[1]

    def set_(s, leaf):
        return dataclasses.replace(s, materials=dataclasses.replace(s.materials, diffuse=leaf))

    G.fd_check(scene, cfg, torch.zeros((W * H, 3)), lambda s: s.materials.diffuse, set_,
               torch.ones_like(scene.materials.diffuse), eps=1e-2, rtol=1e-3)


def test_fd_check_vertex_translation(port_side):
    scene, cfg = port_side[0], port_side[1]
    verts = scene.geom.vertices
    extent = float((verts.max(dim=0).values - verts.min(dim=0).values).max())
    direction = torch.zeros_like(verts)
    direction[:, 2] = 1.0

    def set_(s, leaf):
        return dataclasses.replace(s, geom=refresh_tri_table(
            dataclasses.replace(s.geom, vertices=leaf)))

    ad, fd = G.fd_check(scene, cfg, torch.zeros((W * H, 3)), lambda s: s.geom.vertices,
                        set_, direction, eps=1e-3 * extent, rtol=0.25)
    assert ad < 0 and fd < 0


def test_embedded_jax_constants(jax_side):
    """``chip_smoke.BUNNY_GRAD_REF`` is what the JAX package computes now,
    and the port's own build of the bunny (as ``chip_smoke.py`` runs it on
    the card) meets it at ``BUNNY_GRAD_RTOL``."""
    stats = grad_stats(jax_side["grads"])
    for k, ref in BUNNY_GRAD_REF.items():
        np.testing.assert_allclose(stats[k], ref, rtol=1e-6, err_msg=k)
    for k in BUNNY_GRAD_ZERO:
        assert stats[k][1] == 0.0, k
    scene, cfg = build_scene(_small(get_scene("Project: Bunny")), "cpu")
    g = G.grad_scene(scene, cfg, torch.zeros((W * H, 3)))
    assert bunny_grad_errors(grad_stats(convert.grads_to_arrays(g))) == []


def test_grad_scene_needs_single_bounce(port_side):
    scene, cfg = port_side[0], port_side[1]
    with pytest.raises(NotImplementedError):
        G.grad_scene(scene, dataclasses.replace(cfg, mode="path"), torch.zeros((W * H, 3)))


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

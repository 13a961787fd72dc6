"""The path-gradient slice as a whole: ``grad_scene`` in path mode through
the ``scan`` bounce loop, against the JAX package's
``tracer.diff.grad`` on the very same buffers (``convert.scene_from_arrays``).

* ``W8 E3 Absorption`` at 16x16 and its registry depth 10 (the Cornell box
  of ``chip_smoke.with_fixture_model``: the brute-force engine, two spheres,
  area-light next-event estimation, the mirror, the absorbing dielectric,
  Russian roulette and the firefly clamp);
* ``W8 E1`` and ``W8 E2 Cornell Box Balls`` and ``W7 E3 Cornell Box`` at
  16x16 and their registry depths (10, 50 and 50: the JAX scan over 50
  bounces takes a few seconds here, so nothing is cut);
* ``W9 E1 Bunny`` at 32x32 with ``max_depth`` cut to 3 and the seeded
  environment of ``chip_smoke.seeded_env`` (the packet engine: the B3 twin
  in the forward and the B2 twin in the backward of each bounce's row
  fetch).

Tolerances:
* Leaf by leaf under a mask of disputed pixels: a pixel is disputed when
  its forward radiance in the two packages differs by more than 1e-4
  relative in some channel (the two packages form the brute-force Möller
  numerators and the transcendentals differently, so a path can take
  another id at some bounce and diverge). At most 0.5% of the pixels may be
  masked (none are on these buffers today). The gradient of the L2 over the
  other pixels agrees at rtol 1e-3 with an atol of 1e-4 of the leaf's
  largest magnitude: the port differentiates its float64 square roots and
  transcendentals in float64 and rounds every operation, where XLA fuses
  multiply-adds and sums in other orders. Every float leaf of the JAX
  package's gradient that the port does not return is zero there.
* The port against itself: two runs, the early-exit ``scan`` against a run
  forced through all ``max_depth`` bounces, ``remat="full"`` and ``"dots"``
  against ``"none"``, and ``num_samples=2`` against the mean of two
  ``render_radiance`` passes: bit for bit.
* ``fd_check``: the five probes of ``tests/test_grad.py`` at its ``eps`` and
  ``rtol`` (diffuse 0.15, emission 0.12, a vertex z-translation 0.25, the
  sphere center 0.3 and the camera eye 0.3), on the port's own build at
  10x10 against the target ``clip(0.9 * radiance, 0, 10)``.
* ``chip_smoke.CORNELL_GRAD_REF``: the JAX package's numbers at rtol 1e-6;
  the port's own build meets them at ``CORNELL_GRAD_RTOL``.

The JAX side runs in a child process (``python tests/test_torch_path_grad.py
OUT``): in this JAX version, a jitted render in a process makes a later
second ``tracer.render.progressive.step`` fail, and pytest-xdist may run
other modules that step in the same worker.
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

from chip_smoke import (CORNELL_GRAD_REF, CORNELL_GRAD_RTOL, CORNELL_GRAD_ZERO, FIXTURE_MODELS,
                        bunny_grad_errors, grad_stats, seeded_env, with_fixture_model)

from tracer_torch import convert
from tracer_torch.diff import grad as G
from tracer_torch.geometry.device import refresh_tri_table
from tracer_torch.kernels import scatter_vn, treelet_hits
from tracer_torch.render import integrator
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

# (row, size, max_depth or None for the registry's)
CASES = (("W8 E3 Absorption", 16, None), ("W8 E1 Cornell Box Balls", 16, None),
         ("W8 E2 Cornell Box Balls", 16, None), ("W7 E3 Cornell Box", 16, None),
         ("W9 E1 Bunny", 32, 3))
REPO = Path(__file__).resolve().parents[1]
MAX_MASKED = 0.005


def _sized(desc, size: int, depth=None):
    kw = dict(width=size, height=size, loop="scan")
    if depth is not None:
        kw["max_depth"] = depth
    if os.path.basename(desc.model) in FIXTURE_MODELS:
        desc = with_fixture_model(desc)
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, **kw))


def _port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(SceneConfig)})


def _masked_loss(render, mask):
    """The L2 against target zeros over the pixels of ``mask``."""
    def loss(s):
        img = render(s)
        return (mask[:, None] * img ** 2).sum() / (img.shape[0] * img.shape[1])
    return loss


def _undisputed(port_img, jax_img):
    """Pixels whose radiance agrees within 1e-4 relative in every channel."""
    return (np.abs(port_img - jax_img) <= 1e-4 * np.abs(jax_img)).all(axis=-1)


def _write_jax_side(out: Path) -> None:
    """For each case: the JAX scene's buffers and config, the mask of
    undisputed pixels (the port's radiance on the same buffers against the
    JAX package's), and every float leaf of the JAX package's gradient of
    the masked L2, keyed by its path; the statistics of ``CORNELL_GRAD_REF``
    and whether the JAX package's 32x32 W8 E3 gradient is finite. Pickled
    to ``out``."""
    import jax
    import jax.numpy as jnp

    from tracer.diff import grad as JG
    from tracer.render import texture as jax_texture
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene
    from tracer.util import replace as jax_replace

    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {}
    for name, size, depth in CASES:
        desc = _sized(jax_get_scene(name), size, depth)
        scene, cfg = jax_build_scene(desc)
        if desc.hdri:
            kind = jax_texture.ENV_RGBE if desc.hdri_rgbe else jax_texture.ENV_LDR
            scene = jax_replace(scene, env=jax_texture.TextureBuf(
                data=jnp.asarray(seeded_env(desc.hdri_rgbe)), kind=kind))
        arrays = jax.tree.map(np.asarray, scene)
        jimg = np.asarray(JG.render_radiance(scene, cfg))
        with torch.no_grad():
            pimg = G.render_radiance(convert.scene_from_arrays(arrays, "cpu"),
                                     _port_cfg(cfg)).numpy()
        mask = _undisputed(pimg, jimg).astype(np.float32)
        loss = _masked_loss(lambda s: JG.render_radiance(s, cfg), jnp.asarray(mask))
        g = jax.jit(jax.grad(loss, allow_int=True))(scene)
        leaves = {jax.tree_util.keystr(p)[1:]: np.asarray(x)
                  for p, x in jax.tree_util.tree_leaves_with_path(g)}
        side[name] = dict(scene=arrays, cfg=cfg, mask=mask,
                          grads={k: x for k, x in leaves.items() if x.dtype.kind == "f"})
    scene, cfg = jax_build_scene(_sized(jax_get_scene("W8 E3 Absorption"), 16))
    side["ref"] = grad_stats(convert.grads_to_arrays(
        JG.grad_scene(scene, cfg, jnp.zeros((16 * 16, 3), jnp.float32))))
    scene, cfg = jax_build_scene(_sized(jax_get_scene("W8 E3 Absorption"), 32))
    g = JG.grad_scene(scene, cfg, jnp.zeros((32 * 32, 3), jnp.float32))
    side["jax_32_finite"] = {k: bool(np.isfinite(x).all())
                             for k, x in convert.grads_to_arrays(g).items()}
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_path_grad") / "jax_side.pkl"
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": path})
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


def _check_against_jax(side):
    """The port's gradient of the masked L2 on the JAX scene's buffers
    against the JAX package's, leaf by leaf; returns the port's."""
    scene = convert.scene_from_arrays(side["scene"], "cpu")
    cfg = _port_cfg(side["cfg"])
    mask = side["mask"]
    assert 1.0 - mask.mean() <= MAX_MASKED, f"{int((1 - mask).sum())} pixels disputed"
    got = convert.grads_to_arrays(G.scene_grads(
        scene, _masked_loss(lambda s: G.render_radiance(s, cfg), torch.as_tensor(mask))))
    want = side["grads"]
    for k, g in got.items():
        assert np.isfinite(g).all(), k
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        np.testing.assert_allclose(g, want[k], rtol=1e-3, atol=1e-4 * scale, err_msg=k)
    for k in set(want) - set(got):
        assert not want[k].any(), f"{k} is nonzero in the JAX package's gradient"
    return got


def test_w8e3_gradient_matches_jax(jax_side):
    got = _check_against_jax(jax_side["W8 E3 Absorption"])
    for k in ("camera.eye", "geom.vertices", "materials.diffuse", "materials.emission",
              "spheres.center", "spheres.radius", "spheres.ior", "spheres.extinction"):
        assert np.abs(got[k]).sum() > 0, k


@pytest.mark.parametrize("name", ["W8 E1 Cornell Box Balls", "W8 E2 Cornell Box Balls",
                                  "W7 E3 Cornell Box"])
def test_cornell_rows_match_jax(jax_side, name):
    got = _check_against_jax(jax_side[name])
    assert np.abs(got["camera.eye"]).sum() > 0 and np.abs(got["geom.vertices"]).sum() > 0


def test_w9e1_gradient_matches_jax_through_the_twins(jax_side):
    """The packet engine's rows: B3's twin in the forward and B2's in the
    backward of each bounce's ``fetch_tri_rows`` (T = 69,564 > 128). The
    stand-in's vertex normals point into the mesh, and at this size and
    depth no path that hits it gets out before roulette or the depth limit
    ends it: the bunny's pixels are black and its vertex and normal
    gradients are zero in both packages; the camera and the environment
    map's texels carry the gradient."""
    side = jax_side["W9 E1 Bunny"]
    before = treelet_hits.REFERENCE_CALLS, scatter_vn.REFERENCE_CALLS
    got = _check_against_jax(side)
    b3, b2 = (treelet_hits.REFERENCE_CALLS - before[0], scatter_vn.REFERENCE_CALLS - before[1])
    assert b3 >= 2 and b2 >= 2, (b3, b2)
    assert got["env.data"].shape == (32, 64, 4) and np.abs(got["env.data"]).sum() > 0
    assert np.abs(got["camera.eye"]).sum() > 0
    assert not got["geom.vertices"].any() and not got["geom.normals"].any()


@pytest.fixture(scope="module")
def w8e3():
    scene, cfg = build_scene(_sized(get_scene("W8 E3 Absorption"), 16), "cpu")
    return scene, cfg, torch.zeros((16 * 16, 3))


def _same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k].view(np.int32), b[k].view(np.int32)) for k in a)


def test_two_runs_bitwise(w8e3):
    scene, cfg, target = w8e3
    a = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    b = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    assert _same_bits(a, b)
    assert all(np.isfinite(x).all() for x in a.values())


def test_early_exit_equals_full_depth(w8e3, monkeypatch):
    """The port's ``scan`` stops once every lane is done; forced through
    all ``max_depth`` bounces, as the JAX package's ``scan`` runs, it gives
    the same radiance and gradients bit for bit."""
    scene, cfg, target = w8e3
    bounces = []
    trace = integrator.trace_closest

    def spy(*args, **kw):
        bounces.append(1)
        return trace(*args, **kw)

    monkeypatch.setattr(integrator, "trace_closest", spy)
    out = {}
    for full in (False, True):
        del bounces[:]

        def loss(s):
            img = integrator.render_sample(s, cfg, full_depth=full)
            out[full] = img.detach()
            return torch.mean((img - target) ** 2)

        out[full, "grads"] = convert.grads_to_arrays(G.scene_grads(scene, loss))
        out[full, "bounces"] = len(bounces)
    assert out[False, "bounces"] < out[True, "bounces"] == cfg.max_depth
    assert torch.equal(out[False].view(torch.int32), out[True].view(torch.int32))
    assert _same_bits(out[False, "grads"], out[True, "grads"])
    assert _same_bits(out[False, "grads"],
                      convert.grads_to_arrays(G.grad_scene(scene, cfg, target)))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none(w8e3, remat):
    scene, cfg, target = w8e3
    want = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    got = convert.grads_to_arrays(G.grad_scene(scene, dataclasses.replace(cfg, remat=remat),
                                               target))
    assert _same_bits(got, want)


def test_num_samples_two(w8e3):
    """``num_samples=2`` is the mean of the passes at iterations 0 and 1,
    which differ (the iteration uniform seeds the random streams)."""
    scene, cfg, target = w8e3
    with torch.no_grad():
        r0, r1 = (G.render_radiance(scene, cfg, it) for it in (0, 1))
        mean = G.render_mean(scene, cfg, 2)
    assert not torch.equal(r0, r1)
    assert torch.equal(mean.view(torch.int32), ((r0 + r1) / 2.0).view(torch.int32))

    def loss(s):
        img = (G.render_radiance(s, cfg, 0) + G.render_radiance(s, cfg, 1)) / 2.0
        return torch.mean((img - target) ** 2)

    assert _same_bits(convert.grads_to_arrays(G.grad_scene(scene, cfg, target, num_samples=2)),
                      convert.grads_to_arrays(G.scene_grads(scene, loss)))


def _set(part: str, name: str, refresh: bool = False):
    def set_(s, value):
        new = dataclasses.replace(getattr(s, part), **{name: value})
        return dataclasses.replace(s, **{part: refresh_tri_table(new) if refresh else new})
    return set_


@pytest.fixture(scope="module")
def probe_scene():
    """The scene of ``tests/test_grad.py``: W8 E3 at 10x10 and the target
    ``clip(0.9 * radiance, 0, 10)``."""
    scene, cfg = build_scene(_sized(get_scene("W8 E3 Absorption"), 10), "cpu")
    with torch.no_grad():
        target = torch.clamp(G.render_radiance(scene, cfg) * 0.9, 0.0, 10.0)
    return scene, cfg, target


def _z_only(x):
    d = torch.zeros_like(x)
    d[:, 2] = 1.0
    return d


def _sphere0_y(x):
    d = torch.zeros_like(x)
    d[0, 1] = 1.0
    return d


PROBES = {
    "diffuse": ("materials", "diffuse", lambda x: torch.ones_like(x) * 0.01, 3e-2, 0.15),
    "emission": ("materials", "emission", torch.ones_like, 1e-1, 0.12),
    "vertices": ("geom", "vertices", _z_only, 5e-1, 0.25),
    "sphere_center": ("spheres", "center", _sphere0_y, 5e-1, 0.3),
    "camera_eye": ("camera", "eye", lambda x: torch.tensor([0.0, 0.0, 1.0]), 5e-1, 0.3),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_fd_check(probe_scene, probe):
    scene, cfg, target = probe_scene
    part, name, direction, eps, rtol = PROBES[probe]
    get = lambda s: getattr(getattr(s, part), name)
    ad, fd = G.fd_check(scene, cfg, target, get, _set(part, name, refresh=part == "geom"),
                        direction(get(scene)), eps=eps, rtol=rtol)
    assert ad != 0.0


def test_embedded_jax_constants(jax_side):
    """``chip_smoke.CORNELL_GRAD_REF`` is what the JAX package computes now,
    and the port's own build of W8 E3 (as ``chip_smoke.py`` runs it on the
    card) meets it at ``CORNELL_GRAD_RTOL``."""
    stats = jax_side["ref"]
    assert set(CORNELL_GRAD_REF) == {k for k, v in stats.items() if v[1] != 0.0}
    for k, ref in CORNELL_GRAD_REF.items():
        np.testing.assert_allclose(stats[k], ref, rtol=1e-6, err_msg=k)
    for k in CORNELL_GRAD_ZERO:
        assert stats[k][1] == 0.0, k
    scene, cfg = build_scene(_sized(get_scene("W8 E3 Absorption"), 16), "cpu")
    g = G.grad_scene(scene, cfg, torch.zeros((16 * 16, 3)))
    stats = grad_stats(convert.grads_to_arrays(g))
    assert bunny_grad_errors(stats, CORNELL_GRAD_RTOL, CORNELL_GRAD_REF, CORNELL_GRAD_ZERO) == []


def test_jax_32x32_gradient_is_not_finite(jax_side):
    """Why ``CORNELL_GRAD_REF`` is taken at 16x16: at 32x32 the JAX
    package's W8 E3 gradient is NaN on the camera, the vertices and the
    spheres' center, radius and ior, from lanes whose own cotangent is zero
    (``jnp.maximum``'s derivative selects by a product, 0 x inf, ahead of a
    square root at 0), while the port's is finite everywhere."""
    finite = jax_side["jax_32_finite"]
    assert not finite["camera.eye"] and not finite["geom.vertices"]
    assert finite["materials.diffuse"]
    scene, cfg = build_scene(_sized(get_scene("W8 E3 Absorption"), 32), "cpu")
    g = convert.grads_to_arrays(G.grad_scene(scene, cfg, torch.zeros((32 * 32, 3))))
    assert all(np.isfinite(x).all() for x in g.values())
    assert np.abs(g["camera.eye"]).sum() > 0


def test_small_mesh_rows_take_the_one_hot_product(w8e3, monkeypatch):
    """Meshes of at most 128 triangles fetch their rows by the one-hot
    product, never through ``fetch_tri_rows`` (whose backward is B2)."""
    scene, cfg, target = w8e3
    monkeypatch.setattr(integrator, "fetch_tri_rows", None)
    assert scene.geom.indices.shape[0] == 12
    g = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    assert np.abs(g["geom.vertices"]).sum() > 0


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

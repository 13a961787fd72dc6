"""The Cornell slice as a whole: path mode in the Cornell box on the
brute-force engine (``W8 E3 Absorption`` at 16x16 and 64x64; ``W8 E1`` and
``W8 E2 Cornell Box Balls`` and ``W7 E3 Cornell Box`` at 16x16), and
``Project: Cornell Box``, the direct-mode row that the brute-force route
also admits, at 16x16. Each goes through two ``progressive.step`` frames
against the JAX package's ``tracer.render.progressive.step`` on the very
same buffers (``convert.scene_from_arrays``). Both packages read the
hand-written Cornell boxes of ``tests/fixtures`` through
``chip_smoke.with_fixture_model``.

Tolerances:
* First bounce: the brute-force engine's mesh ids on the primary rays are
  equal, except on lanes that the float64 re-test of
  ``tests/test_torch_brute.py`` finds borderline (each claimed triangle a
  hit within 1e-4 of its boundary, tied claims with t within 1e-4); t at
  rtol 1e-5 where they agree. ``trace_closest``'s valid, mesh and shader
  flags are equal and its t is within rtol 1e-5 on every lane that is not
  borderline for the spheres and the mesh together.
* Radiance: allclose at rtol 1e-4 / atol 1e-5 on at least 99% of the
  pixels, and the image mean within 1e-4 relative. Not everywhere: ulps
  in the per-pair Möller test (the JAX package's is a matrix product),
  in the transcendentals (the port takes them in float64 and rounds) and
  in XLA's fused multiply-adds can send a later bounce of a lane elsewhere,
  which changes that pixel's radiance by far more than an ulp.
* ``chip_smoke.CORNELL_REF``: the JAX package's numbers at rtol 1e-6; the
  port's own build of the row meets them at ``CORNELL_RTOL``.

The JAX side runs in a child process (``python tests/test_torch_cornell.py
OUT``): in this JAX version, a jitted trace in a process makes a later
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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _share_cores import share_cores
from test_torch_brute import borderline, check_ids

from chip_smoke import CORNELL_REF, CORNELL_RTOL, path_errors, path_stats, with_fixture_model
from tracer.kernels import intersect as jax_intersect
from tracer.math import rng as jax_rng
from tracer.render import camera as jax_camera
from tracer.render import integrator as jax_integrator
from tracer.render import progressive as jax_progressive
from tracer.scenes import build_scene as jax_build_scene
from tracer.scenes import get_scene as jax_get_scene

from tracer_torch import convert
from tracer_torch.kernels import intersect
from tracer_torch.render import integrator, progressive
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

CASES = (("W8 E3 Absorption", 16), ("W8 E3 Absorption", 64), ("W8 E1 Cornell Box Balls", 16),
         ("W8 E2 Cornell Box Balls", 16), ("W7 E3 Cornell Box", 16), ("Project: Cornell Box", 16))
ROWS = sorted({name for name, _ in CASES})
TRIANGLES = {"CornellBox.obj": 12, "CornellBoxWithBlocks.obj": 32}
REPO = Path(__file__).resolve().parents[1]


def _sized(desc, size: int):
    desc = with_fixture_model(desc)
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=size, height=size))


def _port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(SceneConfig)})


def _jax_first_bounce(scene, cfg):
    """Frame 0's primary rays (jittered by the first two draws in path mode,
    as ``render_sample`` makes them), the brute-force engine's mesh ids and
    t on them, and ``trace_closest``'s hit record."""
    W, H = cfg.width, cfg.height
    n = W * H
    u, v = jax_camera.pixel_uv(W, H)
    jitter = jnp.zeros((n, 2), jnp.float32)
    if cfg.mode == "path":
        state = jax_rng.pixel_seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
        j1, state = jax_rng.rnd(state)
        j2, state = jax_rng.rnd(state)
        jitter = jnp.stack([j1, j2], -1) / jnp.float32(H)
    r = jax_camera.camera_rays(scene.camera, u, v, jitter)
    rays = jax_intersect.Rays(r.o, r.d, jnp.full(n, cfg.eta, jnp.float32),
                              jnp.full(n, cfg.tmax, jnp.float32))
    t, ids = jax_intersect.mesh_brute_force(rays, scene.geom.vertices, scene.geom.indices)
    hit = jax_integrator.trace_closest(scene, cfg, rays)
    return {k: np.asarray(x) for k, x in dict(
        o=rays.o, d=rays.d, tmin=rays.tmin, tmax=rays.tmax, ids=ids, t=t, valid=hit.valid,
        is_mesh=hit.is_mesh, shader=hit.shader, hit_t=hit.t).items()}


def _write_jax_side(out: Path) -> None:
    """For each case: the JAX scene's buffers and config, its accumulator
    after each of two steps, and its first bounce; and the statistics of
    ``CORNELL_REF``. Pickled to ``out``."""
    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {}
    for name, size in CASES + (("W8 E3 Absorption", 32),):
        scene, cfg = jax_build_scene(_sized(jax_get_scene(name), size))
        st = jax_progressive.init_state(cfg)
        accs = []
        for _ in range(2):
            st = jax_progressive.step(scene, cfg, st)
            accs.append(np.asarray(st.accum).copy())
        side[name, size] = dict(scene=jax.tree.map(np.asarray, scene), cfg=cfg, accs=accs,
                                first=_jax_first_bounce(scene, cfg))
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_cornell") / "jax_side.pkl"
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": path})
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


def _assert_close_image(acc, ref):
    close = np.isclose(acc, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(acc.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


@pytest.mark.parametrize("name,size", CASES)
def test_two_steps_match_jax_on_its_buffers(jax_side, name, size):
    side = jax_side[name, size]
    js = side["scene"]
    scene = convert.scene_from_arrays(js, "cpu")
    cfg = _port_cfg(side["cfg"])
    assert cfg.traversal == "brute" and scene.tb is None
    assert (scene.spheres is not None) == name.startswith("W8")

    first = side["first"]
    if cfg.mode == "path":
        rays, _ = integrator._path_primary(integrator.with_iteration(scene, 0), cfg)
    else:
        rays = integrator.primary_rays(scene, cfg)
    np.testing.assert_allclose(rays.o.numpy(), first["o"], rtol=1e-6)
    np.testing.assert_allclose(rays.d.numpy(), first["d"], rtol=1e-5, atol=1e-6)
    mesh = (js.geom.vertices, np.asarray(js.geom.indices))
    query = (*mesh, first["o"], first["d"], first["tmin"], first["tmax"])
    t, ids = intersect.mesh_brute_force(rays, scene.geom.vertices, scene.geom.indices)
    check_ids(ids.numpy(), first["ids"], t.numpy(), first["t"], query)
    assert (first["ids"] >= 0).mean() > 0.8

    hit = integrator.trace_closest(scene, cfg, rays)
    spheres = [] if scene.spheres is None else list(zip(js.spheres.center, js.spheres.radius))
    keep = ~borderline(first["o"], first["d"], first["tmin"], first["tmax"], *mesh, spheres)
    assert keep.mean() > 0.95
    for key in ("valid", "is_mesh", "shader"):
        assert np.array_equal(getattr(hit, key).numpy()[keep], first[key][keep]), key
    valid = keep & first["valid"]
    np.testing.assert_allclose(hit.t.numpy()[valid], first["hit_t"][valid], rtol=1e-5)
    assert hit.converged.numpy().all()

    st = progressive.init_state(cfg, "cpu")
    for ref in side["accs"]:
        progressive.step(scene, cfg, st)
        acc = st.accum.numpy()
        assert np.isfinite(acc).all()
        if cfg.mode == "path":
            assert (acc >= 0).all()
        _assert_close_image(acc, ref)
    assert st.iteration == 2 and float(st.accum.abs().max()) > 0


def test_embedded_jax_constants(jax_side):
    """``chip_smoke.CORNELL_REF`` is what the JAX package computes now, and
    the port's own build of W8 E3 (as ``chip_smoke.py`` renders it on the
    card) meets it at ``CORNELL_RTOL``."""
    stats = path_stats(jax_side["W8 E3 Absorption", 32]["accs"][1])
    for k, v in CORNELL_REF.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-6, err_msg=k)
    scene, cfg = build_scene(_sized(get_scene("W8 E3 Absorption"), 32), "cpu")
    st = progressive.render_progressive(scene, cfg, 2)
    assert path_errors(path_stats(st.accum.numpy()), CORNELL_RTOL, CORNELL_REF) == []


@pytest.mark.parametrize("name", ROWS)
def test_rows_build_on_the_cpu(jax_side, name):
    """The port's own build of each row: the JAX package's config (routed
    to the brute-force engine), no treelets, the fixture's triangles and
    lights, and the JAX package's spheres."""
    desc = _sized(get_scene(name), 16)
    scene, cfg = build_scene(desc, "cpu")
    jside = jax_side[name, 16]
    jscene = jside["scene"]
    assert cfg == _port_cfg(jside["cfg"]) and cfg.traversal == "brute" and scene.tb is None
    assert scene.geom.indices.shape[0] == TRIANGLES[os.path.basename(desc.model)]
    assert scene.light_indices.tolist() == [10, 11]
    assert np.array_equal(scene.geom.vertices.numpy(), jscene.geom.vertices)
    if name.startswith("W8"):
        for key in ("center", "radius", "shader", "base_color", "ior", "extinction"):
            assert np.array_equal(getattr(scene.spheres, key).numpy(),
                                  getattr(jscene.spheres, key)), key
    else:
        assert scene.spheres is None


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

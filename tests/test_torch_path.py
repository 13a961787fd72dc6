"""The path-mode slice as a whole: ``W9 E1 Bunny`` and ``W9 E2 Bunny`` (path
mode, registry depth 50 with Russian roulette, the 69,564-triangle bunny
stand-in; E2 adds the analytic holdout plane, whose ambient-occlusion probe
is the packet engine's any-hit query) at 32x32 through two
``progressive.step`` frames, against the JAX package's
``tracer.render.progressive.step`` on the very same buffers
(``convert.scene_from_arrays``). Both rows' HDRIs are missing, so both
packages get the same seeded environment map (``chip_smoke.seeded_env``).

Tolerances:
* First bounce: the packet engine's hit ids on the jittered primary rays
  are equal, and so are the valid and mesh masks of ``trace_closest``.
* Radiance: allclose at rtol 1e-4 / atol 1e-5 on at least 99% of the
  pixels, and the image mean within 1e-4 relative. Not everywhere: the
  port takes acos, sin, cos, atan2 and exp2 in float64 and rounds them and
  rounds every multiply-add, where XLA on the CPU uses float32
  approximations and fuses multiply-adds; those ulps in the warps can send
  a later bounce of a lane to another triangle or out of the mesh, which
  changes that pixel's path and its radiance by far more than an ulp.

The JAX side runs in a child process (``python tests/test_torch_path.py
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
import torch
from _share_cores import share_cores

from chip_smoke import PATH_REF, path_errors, path_stats, seeded_env, with_seeded_env
from tracer.accel import packet as jax_packet
from tracer.kernels.intersect import Rays as JaxRays
from tracer.math import rng as jax_rng
from tracer.render import camera as jax_camera
from tracer.render import integrator as jax_integrator
from tracer.render import progressive as jax_progressive
from tracer.render import texture as jax_texture
from tracer.scenes import build_scene as jax_build_scene
from tracer.scenes import get_scene as jax_get_scene
from tracer.util import replace as jax_replace

from tracer_torch import convert
from tracer_torch.accel import packet
from tracer_torch.geometry.device import SHADER_HOLDOUT
from tracer_torch.render import integrator, progressive
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

W = H = 32
ROWS = ("W9 E1 Bunny", "W9 E2 Bunny")
REPO = Path(__file__).resolve().parents[1]


def _small(desc):
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=W, height=H))


def _port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(SceneConfig)})


def _jax_first_bounce(scene, cfg):
    """Frame 0's jittered primary rays (as ``render_sample`` draws them),
    the packet engine's hit ids and ``trace_closest``'s hit record."""
    n = W * H
    u, v = jax_camera.pixel_uv(W, H)
    state = jax_rng.pixel_seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
    j1, state = jax_rng.rnd(state)
    j2, state = jax_rng.rnd(state)
    r = jax_camera.camera_rays(scene.camera, u, v, jnp.stack([j1, j2], -1) / jnp.float32(H))
    rays = JaxRays(r.o, r.d, jnp.full(n, cfg.eta, jnp.float32), jnp.full(n, cfg.tmax, jnp.float32))
    _, ids = jax_packet.closest_hit(rays, scene.tb, frame=(W, H))
    hit = jax_integrator.trace_closest(scene, cfg, rays)
    return dict(ids=np.asarray(ids), valid=np.asarray(hit.valid),
                is_mesh=np.asarray(hit.is_mesh), t=np.asarray(hit.t))


def _write_jax_side(out: Path) -> None:
    """For each row: the JAX scene's buffers (seeded environment included)
    and config, its accumulator after each of two steps, and its first
    bounce. Pickled to ``out``."""
    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {}
    for name in ROWS:
        desc = _small(jax_get_scene(name))
        scene, cfg = jax_build_scene(desc)
        kind = jax_texture.ENV_RGBE if desc.hdri_rgbe else jax_texture.ENV_LDR
        env = jax_texture.TextureBuf(data=jnp.asarray(seeded_env(desc.hdri_rgbe)), kind=kind)
        scene = jax_replace(scene, env=env)
        st = jax_progressive.init_state(cfg)
        accs = []
        for _ in range(2):
            st = jax_progressive.step(scene, cfg, st)
            accs.append(np.asarray(st.accum).copy())
        side[name] = dict(scene=jax.tree.map(np.asarray, scene), cfg=cfg, accs=accs,
                          first=_jax_first_bounce(scene, cfg))
    with open(out, "wb") as f:
        pickle.dump(side, f)


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


def _assert_close_image(acc, ref):
    close = np.isclose(acc, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(acc.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


@pytest.mark.parametrize("name", ROWS)
def test_two_steps_match_jax_on_its_buffers(jax_side, name):
    side = jax_side[name]
    scene = convert.scene_from_arrays(side["scene"], "cpu")
    cfg = _port_cfg(side["cfg"])
    assert scene.env is not None and (scene.planes is not None) == (name == "W9 E2 Bunny")

    rays, _ = integrator._path_primary(integrator.with_iteration(scene, 0), cfg)
    _, ids = packet.closest_hit(rays, scene.tb, frame=(W, H))
    first = side["first"]
    assert np.array_equal(ids.numpy(), first["ids"])
    assert (first["ids"] >= 0).sum() > 500 and (first["ids"] < 0).sum() > 20
    hit = integrator.trace_closest(scene, cfg, rays)
    assert np.array_equal(hit.valid.numpy(), first["valid"])
    assert np.array_equal(hit.is_mesh.numpy(), first["is_mesh"])
    valid = first["valid"]
    np.testing.assert_allclose(hit.t.numpy()[valid], first["t"][valid], rtol=1e-5)
    if name == "W9 E2 Bunny":
        assert int((hit.shader[hit.valid] == SHADER_HOLDOUT).sum()) > 20

    st = progressive.init_state(cfg, "cpu")
    for ref in side["accs"]:
        progressive.step(scene, cfg, st)
        acc = st.accum.numpy()
        assert np.isfinite(acc).all() and (acc >= 0).all()
        _assert_close_image(acc, ref)
    assert st.iteration == 2 and float(st.accum.max()) > 0


def test_embedded_jax_constants(jax_side):
    """``chip_smoke.PATH_REF`` is what the JAX package computes now, and the
    port's own build of W9 E1 Bunny (as ``chip_smoke.py`` renders it on the
    card) meets it at ``PATH_RTOL``."""
    stats = path_stats(jax_side["W9 E1 Bunny"]["accs"][1])
    for k, v in PATH_REF.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-6, err_msg=k)
    desc = _small(get_scene("W9 E1 Bunny"))
    scene, cfg = build_scene(desc, "cpu")
    scene = with_seeded_env(scene, desc, "cpu")
    st = progressive.render_progressive(scene, cfg, 2)
    assert path_errors(path_stats(st.accum.numpy())) == []


@pytest.mark.parametrize("name", ROWS)
def test_rows_build_on_the_cpu(jax_side, name, capfd):
    """The port's own build of both rows: the JAX package's config and
    treelet count, the plane of W9 E2, and no environment map (the HDRI is
    missing) with the JAX package's note."""
    scene, cfg = build_scene(_small(get_scene(name)), "cpu")
    assert "missing" in capfd.readouterr().err
    jscene = jax_side[name]["scene"]
    assert cfg == _port_cfg(jax_side[name]["cfg"])
    assert cfg.mode == "path" and cfg.max_depth == 50
    assert scene.env is None
    assert scene.tb.NT == np.asarray(jscene.tb.blocks).shape[0]
    assert scene.geom.indices.shape[0] == 69_564
    if name == "W9 E2 Bunny":
        assert np.array_equal(scene.planes.normal.numpy(), np.asarray(jscene.planes.normal))
        assert scene.planes.shader.tolist() == [SHADER_HOLDOUT]
    else:
        assert scene.planes is None


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]))

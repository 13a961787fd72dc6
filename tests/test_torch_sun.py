"""Path mode with the sun (``W9 E3 Teapot``'s ``directional`` light: next-
event estimation with a shadow ray to 999999) and the environment map in
direct mode, against the JAX package on the very same buffers
(``convert.scene_from_arrays``).

``W9 E3``'s teapot is missing and has no stand-in in either package, so
the row runs on the bunny stand-in (``chip_smoke.sun_desc``, built the same
way in both packages), and its missing JPEG is replaced by
``chip_smoke.seeded_env``. Two configurations: the row as it is (its
holdout plane; the stand-in's normals point into the mesh, so the sun
lights none of it and every lane's shadow ray is still traced through the
packet engine's any-hit query), and with the plane a grey Lambertian
(``chip_smoke.with_lit_plane``), which the sun lights and the bunny
shadows.

Tolerances:
* Radiance after two ``progressive.step`` frames at 32x32, registry depth
  50: allclose at rtol 1e-4 / atol 1e-5 on at least 99% of the pixels and
  the image mean within 1e-4 relative, as ``tests/test_torch_path.py`` and
  for its reasons (float64 transcendentals in the port, fused
  multiply-adds in XLA). ``chip_smoke.SUN_REF`` is the JAX package's
  numbers at rtol 1e-6; the port's own build meets them at ``SUN_RTOL``.
* The path gradient with the sun (lit plane, 16x16, depth 50, ``scan``,
  target zeros): per-leaf (sum, sum |x|, sum x^2) at ``BUNNY_GRAD_RTOL``
  of each statistic's scale (``chip_smoke.bunny_grad_errors``), and the
  leaves that are zero in JAX are zero in the port.
* Direct mode with the environment map (``W1 E6`` with ``env_light`` and
  the seeded map, 16x16, two frames): misses take the map; allclose at
  ``DIRECT_RTOL``.

The JAX side runs in child processes (``python tests/test_torch_sun.py
OUT CASE``), one per case: in this JAX version, a second scene's step in
a process fails.
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

from chip_smoke import (BUNNY_GRAD_RTOL, DIRECT_RTOL, SUN_REF, SUN_RTOL, bunny_grad_errors,
                        grad_stats, path_errors, path_stats, seeded_env, sun_desc,
                        with_seeded_env)

from tracer_torch import convert
from tracer_torch.accel import packet
from tracer_torch.diff import grad as G
from tracer_torch.kernels import scatter_vn
from tracer_torch.render import progressive
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes import build
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

REPO = Path(__file__).resolve().parents[1]
SIZE, GRAD_SIZE, ENV_SIZE = 32, 16, 16
CASES = {"row": False, "lit plane": True}


def _port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(SceneConfig)})


def _direct_env_desc(get):
    desc = get("W1 E6")
    return dataclasses.replace(desc, cfg=dataclasses.replace(
        desc.cfg, width=ENV_SIZE, height=ENV_SIZE, env_light=True))


def _write_jax_side(out: Path, key: str) -> None:
    """Case ``key``: the JAX scene's buffers and config, and its
    accumulators after each of two steps, or for ``"grad"`` the lit
    plane's gradient statistics. Pickled to ``out``."""
    import jax
    import jax.numpy as jnp

    from tracer.diff import grad as JG
    from tracer.render import progressive as JP
    from tracer.render import texture as JT
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene
    from tracer.util import replace as jax_replace

    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    if key == "grad":
        desc = sun_desc(jax_get_scene, True, GRAD_SIZE)
        desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, loop="scan"))
    elif key == "direct env":
        desc = _direct_env_desc(jax_get_scene)
    else:
        desc = sun_desc(jax_get_scene, CASES[key], SIZE)
    scene, cfg = jax_build_scene(desc)
    env = JT.TextureBuf(data=jnp.asarray(seeded_env(False)), kind=JT.ENV_LDR)
    scene = jax_replace(scene, env=env)
    side = dict(scene=jax.tree.map(np.asarray, scene), cfg=cfg)
    if key == "grad":
        g = JG.grad_scene(scene, cfg, jnp.zeros((GRAD_SIZE * GRAD_SIZE, 3), jnp.float32))
        side["stats"] = grad_stats(convert.grads_to_arrays(g))
    else:
        st = JP.init_state(cfg)
        side["accs"] = []
        for _ in range(2):
            st = JP.step(scene, cfg, st)
            side["accs"].append(np.asarray(st.accum).copy())
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX side, one child process per case, all at once: in this JAX
    version a second scene's step in a process fails ("Execution supplied
    35 buffers but compiled program expected 40")."""
    tmp = tmp_path_factory.mktemp("jax_sun")
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    # The children read no scene cache and write none: every build is fresh.
    env = {**os.environ, "PYTHONPATH": path, "TRACER_NO_SCENE_CACHE": "1"}
    keys = [*CASES, "direct env", "grad"]
    children = [subprocess.Popen([sys.executable, __file__, str(tmp / f"{i}.pkl"), key],
                                 cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                 text=True, env=env) for i, key in enumerate(keys)]
    errors = [child.communicate()[1] for child in children]
    side = {}
    for i, (key, child) in enumerate(zip(keys, children)):
        if child.returncode:
            pytest.fail(f"the JAX side of {key!r} failed:\n{errors[i][-4000:]}")
        with open(tmp / f"{i}.pkl", "rb") as f:
            side[key] = pickle.load(f)
    return side


def _assert_close_image(acc, ref):
    close = np.isclose(acc, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(acc.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


@pytest.mark.parametrize("key", list(CASES))
def test_two_steps_match_jax_on_its_buffers(jax_side, key, monkeypatch):
    side = jax_side[key]
    scene = convert.scene_from_arrays(side["scene"], "cpu")
    cfg = _port_cfg(side["cfg"])
    assert cfg.lights == ("directional",) and cfg.mode == "path" and cfg.max_depth == 50
    queries = []
    any_hit = packet.any_hit

    def spy(rays, *args, **kw):
        queries.append(int((rays.tmax > rays.tmin).sum()))
        return any_hit(rays, *args, **kw)

    monkeypatch.setattr(packet, "any_hit", spy)
    st = progressive.init_state(cfg, "cpu")
    for ref in side["accs"]:
        progressive.step(scene, cfg, st)
        acc = st.accum.numpy()
        assert np.isfinite(acc).all() and (acc >= 0).all()
        _assert_close_image(acc, ref)
    assert queries and max(queries) > 0  # the sun's shadow rays ran the any-hit query
    if key == "lit plane":
        # The sun lights the plane: the image is brighter than the row's.
        assert acc.sum() > jax_side["row"]["accs"][1].sum()


def test_embedded_jax_constants(jax_side):
    """``chip_smoke.SUN_REF`` is what the JAX package computes now, and the
    port's own build (as ``chip_smoke.py`` renders it on the card) meets it
    at ``SUN_RTOL``."""
    for key, lit in CASES.items():
        stats = path_stats(jax_side[key]["accs"][1])
        for k, v in SUN_REF[key].items():
            np.testing.assert_allclose(stats[k], v, rtol=1e-6, err_msg=f"{key} {k}")
        desc = sun_desc(get_scene, lit, SIZE)
        scene, cfg = build_scene(desc, "cpu")
        st = progressive.render_progressive(with_seeded_env(scene, desc, "cpu"), cfg, 2)
        assert path_errors(path_stats(st.accum.numpy()), SUN_RTOL, SUN_REF[key]) == [], key


def test_sun_gradient_matches_jax(jax_side):
    side = jax_side["grad"]
    scene = convert.scene_from_arrays(side["scene"], "cpu")
    cfg = _port_cfg(side["cfg"])
    assert scene.geom.indices.shape[0] > 128  # rows fetched through B2's twin
    before = scatter_vn.REFERENCE_CALLS
    g = G.grad_scene(scene, cfg, torch.zeros((GRAD_SIZE * GRAD_SIZE, 3)))
    assert scatter_vn.REFERENCE_CALLS > before
    stats = grad_stats(convert.grads_to_arrays(g))
    want = side["stats"]
    ref = {k: v for k, v in want.items() if v[1] != 0.0}
    zero = tuple(k for k, v in want.items() if v[1] == 0.0 and k in stats)
    assert {"planes.base_color", "camera.eye", "env.data"} <= set(ref)
    assert bunny_grad_errors(stats, BUNNY_GRAD_RTOL, ref, zero) == []


def test_direct_mode_environment_map(jax_side):
    side = jax_side["direct env"]
    scene = convert.scene_from_arrays(side["scene"], "cpu")
    cfg = _port_cfg(side["cfg"])
    assert cfg.mode == "direct" and cfg.env_light and scene.env is not None
    st = progressive.init_state(cfg, "cpu")
    for ref in side["accs"]:
        progressive.step(scene, cfg, st)
        np.testing.assert_allclose(st.accum.numpy(), ref, rtol=DIRECT_RTOL, atol=0)
    # Misses see the map, not the background colour.
    bg = np.asarray(cfg.bg_color, np.float32)
    assert not (st.accum.numpy() == bg).all(axis=-1).any()
    assert build.unsupported(_direct_env_desc(get_scene), cfg) == []


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]), sys.argv[2])

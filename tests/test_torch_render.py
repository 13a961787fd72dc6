"""The ported slice as a whole: ``Project: Bunny`` (the procedural stand-in,
69k triangles) at 64x48 through two progressive steps, the second one
seeded with the first one's hit distances, against the JAX package.

Both sides first run on the very same buffers (the JAX scene carried over
with ``convert.scene_from_arrays``), then the port runs on its own
``build_scene``.

Tolerance: hit ids must be equal except on at most 0.5% of lanes; where
they agree, the accumulated radiance agrees at rtol 1e-5 / atol 1e-6 (the
same float32 formulas, but XLA on the CPU contracts multiply-adds into FMAs
where PyTorch rounds each operation). Miss pixels must equal the
background colour bitwise on both sides. Seeded and unseeded renders of
the port are compared bitwise. The integrator's table of mesh engines is
held to the entry point and arguments that each traversal and mode call
for.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from tracer.accel import flat as jax_flat
from tracer.kernels.intersect import Rays as JaxRays
from tracer.render import camera as jax_camera
from tracer.render import progressive as jax_progressive
from tracer.scenes import build_scene as jax_build_scene
from tracer.scenes import get_scene as jax_get_scene

from chip_smoke import with_fixture_model
from tracer_torch import convert
from tracer_torch.accel import bsp as bsp_mod
from tracer_torch.accel import flat, packet, traverse, wide
from tracer_torch.kernels import intersect
from tracer_torch.render import integrator
from tracer_torch.render import progressive
from tracer_torch.render.camera import camera_rays, make_camera, pixel_uv
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

W, H = 64, 48


def _small(desc, w=W, h=H):
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=w, height=h))


def _port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(SceneConfig)})


@pytest.fixture(scope="module")
def jax_run():
    """JAX scene, its accumulators after steps 1 and 2, and its hit ids."""
    scene, cfg = jax_build_scene(_small(jax_get_scene("Project: Bunny")))
    st = jax_progressive.init_state(cfg)
    accs = []
    for _ in range(2):
        st = jax_progressive.step(scene, cfg, st)
        accs.append(np.asarray(st.accum).copy())
    u, v = jax_camera.pixel_uv(W, H)
    r = jax_camera.camera_rays(scene.camera, u, v)
    n = W * H
    rays = JaxRays(r.o, r.d, np.full(n, cfg.eta, np.float32),
                   np.full(n, cfg.tmax, np.float32))
    trace = jax.jit(jax_flat.closest_hit, static_argnames=("frame",))
    _, ids = trace(rays, scene.tb, frame=(W, H))
    return scene, cfg, accs, np.asarray(ids), np.asarray(st.seed_t)


@pytest.fixture(scope="module")
def port_run():
    """The port's own build of the same row (cheap on the CPU: the stand-in
    mesh, the native LBVH and the treelet cut take well under a second)."""
    return build_scene(_small(get_scene("Project: Bunny")), "cpu")


def _port_ids(scene, cfg):
    rays = integrator.primary_rays(scene, cfg)
    return flat.closest_hit(rays, scene.tb, frame=(W, H))[1].numpy()


def _compare(jax_run, scene, cfg):
    _, jcfg, accs, jids, jseed = jax_run
    st = progressive.init_state(cfg, "cpu")
    ids = _port_ids(scene, cfg)
    same = ids == jids
    assert (~same).mean() <= 0.005, f"{(~same).sum()} ids differ"
    assert (ids >= 0).sum() > 1000 and (ids < 0).sum() > 100
    miss = same & (ids < 0)
    bg = np.asarray(jcfg.bg_color, np.float32)
    for ref in accs:
        progressive.step(scene, cfg, st)
        acc = st.accum.numpy()
        np.testing.assert_allclose(acc[same], ref[same], rtol=1e-5, atol=1e-6)
        assert np.array_equal(acc[miss], np.broadcast_to(bg, acc[miss].shape))
        assert np.array_equal(ref[miss], np.broadcast_to(bg, ref[miss].shape))
        assert not np.isnan(acc).any()
    assert st.iteration == 2
    seed = st.seed_t.numpy()
    assert np.array_equal(seed > 0, ids >= 0)
    np.testing.assert_allclose(seed[same], jseed[same], rtol=1e-5)
    img = progressive.image(st, cfg)
    assert img.shape == (H, W, 3) and (img >= 0).all() and (img <= 1).all()


def test_two_steps_match_jax_on_its_buffers(jax_run):
    jscene, jcfg = jax_run[0], jax_run[1]
    scene = convert.scene_from_arrays(jax.tree.map(np.asarray, jscene), "cpu")
    _compare(jax_run, scene, _port_cfg(jcfg))


def test_port_build_scene_matches_jax(jax_run, port_run):
    scene, cfg = port_run
    assert cfg == _port_cfg(jax_run[1])
    assert scene.tb.NT == jax_run[0].tb.blocks.shape[0]
    _compare(jax_run, scene, cfg)


def test_seeded_render_equals_unseeded(port_run):
    """Temporal seeding is an accelerator, not an approximation: with a
    good, a far too tight or a garbage seed the radiance is the unseeded
    render's (a zero seed is no hint), bit for bit. A 16x16 frame of the
    same scene keeps this quick."""
    scene, cfg = port_run
    cfg = dataclasses.replace(cfg, width=16, height=16)
    st = progressive.init_state(cfg, "cpu")
    progressive.step(scene, cfg, st)  # frame 1: the zero seed is no hint
    base, seed = st.accum.clone(), st.seed_t
    assert bool((seed > 0).any()) and bool((seed == 0).any())
    # Frame 2 is seeded with frame 1's depths; the mean of two equal
    # frames is the frame itself, exactly.
    st = progressive.render_progressive(scene, cfg, 2, st)
    assert st.iteration == 2 and torch.equal(st.accum, base)
    for s in (seed * 0.05, torch.full_like(seed, 1e-4)):
        r, _ = integrator.render_sample_seeded(scene, cfg, s)
        assert torch.equal(base, r)


def test_camera_rays_match_jax():
    cam = dict(get_scene("Project: Dragon").camera)
    u, v = pixel_uv(80, 45, device="cpu")
    ju, jv = jax_camera.pixel_uv(80, 45)
    assert np.array_equal(u.numpy(), np.asarray(ju))
    r = camera_rays(make_camera(**cam, device="cpu"), u, v)
    jr = jax_camera.camera_rays(jax_camera.make_camera(**cam), ju, jv)
    np.testing.assert_array_max_ulp(r.o.numpy(), np.asarray(jr.o), maxulp=0)
    np.testing.assert_array_max_ulp(r.d.numpy(), np.asarray(jr.d), maxulp=2)


def test_to_display_paints_negative_and_nan():
    cfg = SceneConfig(gamma=1.5)
    acc = torch.tensor([[0.25, 0.5, 2.0], [-1.0, 0.0, 0.0], [float("nan"), 0, 0]])
    out = integrator.to_display(acc, cfg)
    assert torch.allclose(out[0], torch.tensor([0.125, 0.5 ** 1.5, 1.0]))
    assert torch.equal(out[1], torch.tensor(integrator.ERROR_COLOR))
    assert torch.equal(out[2], torch.tensor(integrator.ERROR_COLOR))


# (traversal, bsp_execution) -> the engine module each mode reaches; None:
# the flat engine in direct mode, the packet engine in path mode.
ENGINE_CASES = {
    "brute": ("brute", "fast", intersect),
    "bsp_fast": ("bsp", "fast", None),
    "bsp_walked": ("bsp", "walk", bsp_mod),
    "bvh2": ("bvh2", "fast", traverse),
    "bvh8": ("bvh8", "fast", wide),
    "bvh": ("bvh", "fast", None),
}
ENTRY_POINTS = {intersect: ("mesh_brute_force", "mesh_brute_force_anyhit"),
                bsp_mod: ("bsp_closest_hit", "bsp_any_hit"),
                traverse: ("bvh_closest_hit", "bvh_any_hit"),
                wide: ("closest_hit", "any_hit"), flat: ("closest_hit", "any_hit"),
                packet: ("closest_hit", "any_hit")}


@pytest.fixture(scope="module")
def engine_scene():
    """The 12-triangle Cornell box at 8x8, with stand-ins for the four
    structures the engines walk."""
    scene, cfg = build_scene(_small(with_fixture_model(get_scene("W8 E3 Absorption")), 8, 8),
                             "cpu")
    marks = {k: type(k, (), {})() for k in ("tb", "bsp", "bvh", "wide")}
    return dataclasses.replace(scene, **marks), cfg


@pytest.mark.parametrize("mode", ["direct", "path"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mesh_engine_reaches_what_the_chains_reached(engine_scene, monkeypatch, case, mode):
    """``trace_closest`` and ``_mesh_only_anyhit`` each call exactly one
    engine entry point, with its arguments: the brute-force engine, the
    BSP walk (``bsp`` walked), the ``bvh2`` walk with ``max_leaf``, the
    ``bvh8`` walk, or the flat engine (direct mode, with the detached seed)
    and the packet engine (path mode) for ``bvh`` and ``bsp`` run fast; a
    capped engine's converged flags reach the hit, an uncapped one
    converges everywhere. ``host_free`` holds for the brute-force engine
    only, ``seeded`` for the flat engine only."""
    scene, cfg = engine_scene
    trav, execution, mod = ENGINE_CASES[case]
    cfg = dataclasses.replace(cfg, traversal=trav, bsp_execution=execution, mode=mode)
    mod = mod or (flat if mode == "direct" else packet)
    g = scene.geom
    structure = {intersect: (), bsp_mod: (scene.bsp,), traverse: (scene.bvh,),
                 wide: (scene.wide,), flat: (scene.tb,), packet: (scene.tb,)}[mod]
    args = structure + ((g.vertices, g.indices) if mod in (intersect, bsp_mod, traverse) else ())
    kwargs = ({"max_leaf": cfg.max_leaf} if mod is traverse else {} if mod is intersect
              else {"with_conv": True} if mod in (bsp_mod, wide)
              else {"frame": (8, 8), "with_conv": True})
    capped = mod not in (intersect, traverse)

    calls = []

    def spy(name, any_hit):
        def entry(rays, *a, **kw):
            calls.append((name, a, kw))
            n = rays.o.shape[0]
            conv = torch.ones(n, dtype=torch.bool)
            conv[0] = False
            if any_hit:
                blocked = torch.zeros(n, dtype=torch.bool)
                return (blocked, conv) if kw.get("with_conv") else blocked
            tri = torch.full((n,), -1, dtype=torch.int32)
            return (rays.tmax, tri, conv) if kw.get("with_conv") else (rays.tmax, tri)
        return entry

    for m, names in ENTRY_POINTS.items():
        for name, any_hit in zip(names, (False, True)):
            monkeypatch.setattr(m, name, spy(f"{m.__name__}.{name}", any_hit))
    closest, any_hit = (f"{mod.__name__}.{n}" for n in ENTRY_POINTS[mod])
    rays = integrator.primary_rays(scene, cfg)
    seed = torch.full((64,), 2.0, requires_grad=True)

    hit = integrator.trace_closest(scene, cfg, rays, seed_t=seed)
    assert [c[0] for c in calls] == [closest]
    _, got_args, got_kw = calls.pop()
    if mod is flat:
        s = got_kw.pop("seed_t")
        assert not s.requires_grad and torch.equal(s, seed)
    assert len(got_args) == len(args) and all(a is b for a, b in zip(got_args, args))
    assert got_kw == kwargs
    assert hit.converged.tolist() == [not capped or i > 0 for i in range(64)]

    blocked, conv = integrator._mesh_only_anyhit(scene, cfg, rays)
    assert [c[0] for c in calls] == [any_hit]
    _, got_args, got_kw = calls.pop()
    assert len(got_args) == len(args) and all(a is b for a, b in zip(got_args, args))
    assert got_kw == kwargs
    assert not blocked.any() and conv.tolist() == [not capped or i > 0 for i in range(64)]

    engine = integrator._mesh_engine(scene, cfg)
    assert engine.host_free == (mod is intersect)
    assert engine.seeded == (mod is flat)

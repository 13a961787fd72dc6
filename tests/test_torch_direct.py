"""Direct mode as a whole (worksheets 1-7, ``W6 E1``, the ``Project: ... BSP``
rows and the shadowed frame on a stand-in mesh): two ``progressive.step``
frames of each row against the JAX package's ``tracer.render.progressive.
step`` on the very same buffers (``convert.scene_from_arrays``), and the
pieces under it: ``compute_jitters``, the texture samplers, the port's own
scene build, and ``grad_scene`` on six of the cases (``GRAD_KEYS``)
against the JAX package's gradient (``tests/_direct_grad.py``'s checks).

Cases: W1 E1-E6, W2 E1-E5 (W2 E5 also with the sphere and plane
selections (4, 1): glossy and Phong, and (7, 5): the transparent shader,
which direct mode makes the deterministic transmit, and the normal arm)
and W3 E1-E4 at 32x32; W3 with ``chip_smoke.seeded_texture`` bound under
``TEX_DEFAULT``, and W3 E3/E4 also under ``TEX_NEAREST`` with ``uv_scale``
(2, 2) (``grass.jpg`` is missing, so the rows as built keep the plane's
base colour in both packages); the Cornell rows (``W5 E4``/``E5``, ``W6
E2``/``E3``, ``W7 E1``/``E2``, through ``chip_smoke.with_fixture_model``)
at 16x16; ``W6 E1 Bunny`` and ``W5 E3 Teapot`` on the bunny stand-in
(``chip_smoke.with_standin_mesh``: the shadowed frame on a large mesh) at
64x48; ``Project: Bunny BSP`` at 32x24 and ``Project: Dragon BSP`` at
16x8 (see ``_cases``).

Tolerances:
* W1 E1-E3 (background only): bit for bit.
* The rest: allclose at rtol 1e-4 / atol 1e-5 on at least 99% of the
  pixels, and the image mean within 1e-4 relative, over the pixels that
  are not disputed. A pixel is disputed when one of its queries (every
  closest-hit and shadow ray the port's frame traced for it, recorded by
  a spy) is borderline under the float64 re-test of
  ``tests/test_torch_brute.py`` (a triangle or sphere within 1e-4 of an
  acceptance boundary, or two nearest hits within 1e-4 of each other).
  Every pixel that differs must be disputed. The Cornell rows' shadow rays
  start on the surface they leave, and where ``eta`` is 1e-5 (``W6 E2``)
  that surface's own t lies within float32 noise of ``tmin``: which lanes
  shadow themselves there turns on rounding (XLA on the CPU contracts
  multiply-adds and forms the brute-force numerators as a matrix product;
  the port rounds each pairwise operation), as it does in the reference.
  Those lanes are disputed, and no global tolerance is widened for them.

The JAX side runs in a child process (``python tests/test_torch_direct.py
OUT``), as in ``tests/test_torch_cornell.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from _direct_grad import check_case, jax_gradient_side
from _share_cores import share_cores
from test_torch_brute import borderline

from chip_smoke import (CORNELL_REF, CORNELL_RTOL, DIRECT_REF, DIRECT_RTOL, FIXTURE_MODELS,
                        path_errors, path_stats, seeded_env, seeded_texture, with_fixture_model,
                        with_seeded_env, with_standin_mesh)

from tracer_torch import convert
from tracer_torch.diff import grad as G
from tracer_torch.math.sampling import compute_jitters
from tracer_torch.render import integrator, progressive
from tracer_torch.render import texture as tex
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes import build
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

REPO = Path(__file__).resolve().parents[1]
BACKGROUND = ("W1 E1", "W1 E2", "W1 E3")
ANALYTIC = ("W1 E4", "W1 E5", "W1 E6", "W2 E1", "W2 E2", "W2 E3", "W2 E4", "W2 E5")
TEXTURED = ("W3 E1", "W3 E2", "W3 E3", "W3 E4")
CORNELL = ("W5 E4 Cornell Box", "W5 E5 Cornell Box", "W6 E2 Cornell Box",
           "W6 E3 Cornell Box", "W7 E1 Cornell Box", "W7 E2 Cornell Box")
MESHES = ("W6 E1 Bunny", "Project: Bunny BSP", "Project: Dragon BSP")
SHADOWED = "W5 E3 Teapot"  # on the bunny stand-in, see ``with_standin_mesh``
FLAT_CASES = MESHES + ("W5 E3 shadowed bunny",)  # the cases that reach the flat engine
# The cases whose gradient is held to the JAX package here; the JAX package
# compiles SLOW_GRAD's (16 sub-samples) for about a minute, in a child of
# its own (GRAD_ONLY marks such a child's keys).
GRAD_KEYS = ("W1 E6", "W2 E2", "W3 E3 texture", "W5 E5 Cornell Box", "W6 E1 Bunny",
             "W5 E3 shadowed bunny")
SLOW_GRAD = "W3 E3 texture"
GRAD_ONLY = "--gradient-only"


def _cases() -> dict:
    """key -> (row, (W, H), selections or None, texture (mode, uv_scale)
    or None, stand-in model or None)."""
    cases = {r: (r, (32, 32), None, None, None) for r in BACKGROUND + ANALYTIC}
    cases["W2 E5 glossy+phong"] = ("W2 E5", (32, 32), (4, 1), None, None)
    cases["W2 E5 transparent+normal"] = ("W2 E5", (32, 32), (7, 5), None, None)
    for r in TEXTURED:
        cases[r] = (r, (32, 32), None, None, None)
        cases[f"{r} texture"] = (r, (32, 32), None, (tex.TEX_DEFAULT, (1.0, 1.0)), None)
    for r in ("W3 E3", "W3 E4"):
        cases[f"{r} nearest"] = (r, (32, 32), None, (tex.TEX_NEAREST, (2.0, 2.0)), None)
    cases.update({r: (r, (16, 16), None, None, None) for r in CORNELL})
    cases["W6 E3 Cornell Box 32x32"] = ("W6 E3 Cornell Box", (32, 32), None, None, None)
    # The BSP rows differ from ``Project: Bunny``/``Dragon`` (held to the JAX
    # package at 64x48 in ``tests/test_torch_render.py`` and on the card)
    # only in the traversal they name, which the treelet engines execute.
    # The flat engine's CPU frame (B1's plain twin) takes minutes for the
    # dragon at 64x48 on one core, so these two run smaller: the bunny at
    # 32x24, the dragon on one sub-tile (16x8).
    cases["W6 E1 Bunny"] = ("W6 E1 Bunny", (64, 48), None, None, None)
    cases["Project: Bunny BSP"] = ("Project: Bunny BSP", (32, 24), None, None, None)
    cases["Project: Dragon BSP"] = ("Project: Dragon BSP", (16, 8), None, None, None)
    cases["W5 E3 shadowed bunny"] = (SHADOWED, (64, 48), None, None, "bunny.obj")
    return cases


CASES = _cases()


def case_desc(key: str, get):
    """The descriptor of case ``key`` from the registry getter ``get`` (the
    JAX package's or the port's)."""
    row, (w, h), sel, _, standin = CASES[key]
    desc = get(row)
    if standin is not None:
        desc = with_standin_mesh(desc, standin)
    elif os.path.basename(desc.model or "") in FIXTURE_MODELS:
        desc = with_fixture_model(desc)
    if sel is not None:
        desc = dataclasses.replace(desc, selection1=sel[0], selection2=sel[1])
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=w, height=h))


# Texture lookups held against the JAX package's: uv in and far outside
# [0, 1), on texel edges, and negative.
def _lookup_uv():
    rs = np.random.RandomState(3)
    u = np.concatenate([rs.uniform(-2.0, 3.0, 500), np.arange(-8, 9) / 8.0]).astype(np.float32)
    v = np.concatenate([rs.uniform(-2.0, 3.0, 500), np.arange(-8, 9) / 16.0]).astype(np.float32)
    return u, v


def _lookup_texture(kind):
    return seeded_env(kind == tex.ENV_RGBE, 1, (5, 7))


SAMPLERS = ("nearest", tex.TEX_NONE, tex.TEX_DEFAULT, tex.TEX_BILINEAR, tex.TEX_NEAREST)


# --- The JAX side (child process) -----------------------------------------


def _jax_case(key, jax_build_scene, jax_get_scene, jax_tex, jax_replace, jnp):
    """The JAX package's scene and config of case ``key``."""
    scene, cfg = jax_build_scene(case_desc(key, jax_get_scene))
    texture = CASES[key][3]
    if texture is not None:
        # A new name, so that this JAX version compiles the step afresh
        # for the scene with a texture (it would reuse the program
        # compiled for the same config without one).
        cfg = dataclasses.replace(cfg, name=f"{cfg.name} (seeded texture)")
        mode, uv_scale = texture
        scene = jax_replace(
            scene, texture=jax_tex.TextureBuf(data=jnp.asarray(seeded_texture()),
                                              kind=jax_tex.ENV_LDR),
            uniforms=jax_replace(scene.uniforms, use_texture=jnp.int32(mode),
                                 uv_scale=jnp.asarray(uv_scale, jnp.float32)))
    return scene, cfg


def _write_jax_side(out: Path, keys: list) -> None:
    """The JAX side of the cases ``keys``, pickled to ``out``: each case's
    scene buffers and config and its accumulator after each of two steps;
    with the flat-engine-free group (``keys`` empty) also the jitter tables
    and the texture lookups."""
    import jax
    import jax.numpy as jnp

    from tracer.math import sampling as jax_sampling
    from tracer.render import progressive as jax_progressive
    from tracer.render import texture as jax_tex
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene
    from tracer.util import replace as jax_replace

    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {"cases": {}, "jitters": {}, "samples": {}, "grads": {}}
    if keys and keys[0] == GRAD_ONLY:
        # A case's gradient alone, in a child of its own.
        for key in keys[1:]:
            scene, cfg = _jax_case(key, jax_build_scene, jax_get_scene, jax_tex, jax_replace, jnp)
            side["grads"][key] = jax_gradient_side(scene, cfg)
        with open(out, "wb") as f:
            pickle.dump(side, f)
        return
    shared = not keys
    built = {}
    for key in keys or [k for k in CASES if k not in FLAT_CASES]:
        scene, cfg = _jax_case(key, jax_build_scene, jax_get_scene, jax_tex, jax_replace, jnp)
        built[key] = scene, cfg
        st = jax_progressive.init_state(cfg)
        accs = []
        for _ in range(2):
            st = jax_progressive.step(scene, cfg, st)
            accs.append(np.asarray(st.accum).copy())
        side["cases"][key] = dict(scene=jax.tree.map(np.asarray, scene), cfg=cfg, accs=accs)
    # The gradients after every step: a jitted render in this JAX version
    # breaks a later progressive.step in the process.
    for key in set(built) & set(GRAD_KEYS):
        side["grads"][key] = jax_gradient_side(*built[key])
    if not shared:
        with open(out, "wb") as f:
            pickle.dump(side, f)
        return
    for size in (32, 450, 512):
        for subdivs in range(1, 11):
            side["jitters"][size, subdivs] = jax_sampling.compute_jitters(1.0 / size, subdivs)
    u, v = _lookup_uv()
    for kind in (jax_tex.ENV_LDR, jax_tex.ENV_RGBE):
        t = jax_tex.TextureBuf(data=jnp.asarray(_lookup_texture(kind)), kind=kind)
        for mode in SAMPLERS:
            fn = (lambda a, b: jax_tex.sample_nearest(t, a, b)) if mode == "nearest" else \
                (lambda a, b, m=mode: jax_tex.sample(t, a, b, jnp.int32(m)))
            side["samples"][kind, mode] = np.asarray(fn(jnp.asarray(u), jnp.asarray(v)))
    with open(out, "wb") as f:
        pickle.dump(side, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX side, from one child for the cases that do not reach the
    flat engine and one child for each case that does: in this JAX version
    a second scene's flat-engine step in a process fails ("Execution
    supplied 25 buffers but compiled program expected 30"); and one for
    ``SLOW_GRAD``'s gradient alone. Three children run at a time."""
    tmp = tmp_path_factory.mktemp("jax_direct")
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    # The children read no scene cache and write none: every build is fresh.
    env = {**os.environ, "PYTHONPATH": path, "TRACER_NO_SCENE_CACHE": "1"}
    groups = [[]] + [[k] for k in FLAT_CASES] + [[GRAD_ONLY, SLOW_GRAD]]
    outs = [tmp / f"jax_side_{i}.pkl" for i in range(len(groups))]

    def run(i):
        return subprocess.run([sys.executable, __file__, str(outs[i]), *groups[i]], cwd=REPO,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                              env=env)

    with ThreadPoolExecutor(3) as pool:
        for done in pool.map(run, range(len(groups))):
            if done.returncode:
                pytest.fail(f"the JAX side failed:\n{done.stderr[-4000:]}")
    side: dict = {}
    for out in outs:
        with open(out, "rb") as f:
            part = pickle.load(f)
        for k, v in part.items():
            side.setdefault(k, {}).update(v)
    return side


# --- The port side ---------------------------------------------------------


def _port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(SceneConfig)})


class _Spy:
    """Records the rays of every closest-hit and shadow query of a frame,
    and the closest hits."""

    def __init__(self):
        self.queries, self.hits = [], []

    def __enter__(self):
        self.orig = (integrator.trace_closest, integrator.trace_occluded)

        def closest(sc, c, rays, *a, **kw):
            self.queries.append(rays)
            self.hits.append(self.orig[0](sc, c, rays, *a, **kw))
            return self.hits[-1]

        def occluded(sc, c, rays):
            self.queries.append(rays)
            return self.orig[1](sc, c, rays)

        integrator.trace_closest, integrator.trace_occluded = closest, occluded
        return self

    def __exit__(self, *exc):
        integrator.trace_closest, integrator.trace_occluded = self.orig


# The float64 re-test. A triangle's barycentric margin is borderline within
# EPS_B of 0 (``tests/test_torch_brute.py``'s EPS); its t, and the gap
# between a query's two nearest hits, within TAU_ULPS float32 ulps of |o| +
# the mesh's largest coordinate over the cosine of the incidence: the
# cancellation error of either package's float32 t numerator (the JAX
# package forms n.v0 - n.o, the port (v0 - o).n). The shadow rays start on
# a surface and end eta short of a light, so their window ends are where
# rounding decides.
EPS_B = 1e-4
TAU_ULPS = 2


def query_borderline(o, d, tmin, tmax, verts=None, idx=None, spheres=()):
    """Lanes of one query whose answer can turn on float32 rounding (see
    ``EPS_B``, ``TAU_ULPS``); spheres as in ``tests/test_torch_brute.py``."""
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    tmin, tmax = np.asarray(tmin, np.float64), np.asarray(tmax, np.float64)
    scale = np.abs(o).max(axis=1)
    near = borderline(o, d, tmin, tmax, None, None, spheres) if spheres else \
        np.zeros(o.shape[0], bool)
    ts = [np.full((o.shape[0], 1), np.inf)]
    if verts is not None:
        V = np.asarray(verts, np.float64)
        scale = scale + np.abs(V).max()
        v0, v1, v2 = (V[np.asarray(idx)[:, k]][None] for k in range(3))
        e0, e1 = v1 - v0, v2 - v0
        n = np.cross(e0, e1)
        ov = v0 - o[:, None]
        nom = np.cross(ov, d[:, None])
        with np.errstate(divide="ignore", invalid="ignore"):
            dn = (d[:, None] * n).sum(-1)
            beta = (nom * e1).sum(-1) / dn
            gamma = -(nom * e0).sum(-1) / dn
            t = (ov * n).sum(-1) / dn
            bary = np.minimum.reduce([beta, gamma, 1.0 - beta - gamma])
            cos = np.abs(dn) / np.linalg.norm(n, axis=-1)
            tau = TAU_ULPS * 2.0 ** -23 * scale[:, None] / cos
        inside = (t >= tmin[:, None] - tau) & (t <= tmax[:, None] + tau)
        at_end = (np.abs(t - tmin[:, None]) <= tau) | (np.abs(t - tmax[:, None]) <= tau)
        edge = np.abs(bary) <= EPS_B
        near |= ((edge & inside) | (at_end & (bary >= -EPS_B))).any(axis=1)
        ok = (bary >= 0) & (t >= tmin[:, None]) & (t <= tmax[:, None])
        ts.append(np.where(ok, t, np.inf))
        tau_lane = TAU_ULPS * 2.0 ** -23 * scale
    else:
        tau_lane = TAU_ULPS * 2.0 ** -23 * scale
    t_all = np.sort(np.concatenate(ts, axis=1), axis=1)
    if t_all.shape[1] > 1:
        with np.errstate(invalid="ignore"):
            near |= np.isfinite(t_all[:, 0]) & (t_all[:, 1] - t_all[:, 0] <= tau_lane)
    return near


def disputed(scene, cfg, lanes) -> np.ndarray:
    """Which of the pixels ``lanes`` have a query that is borderline in
    float64 (``query_borderline``), over one frame of the port's render."""
    with _Spy() as spy:
        integrator.render_sample(scene, cfg)
    verts = idx = None
    if scene.geom is not None:
        verts, idx = scene.geom.vertices.numpy(), scene.geom.indices.numpy()
    spheres = [] if scene.spheres is None else list(
        zip(scene.spheres.center.numpy(), scene.spheres.radius.numpy()))
    out = np.zeros(lanes.shape[0], bool)
    # Lanes per float64 pass: about 2M (lane, triangle) pairs at a time.
    step = max(1, 2_000_000 // (1 if idx is None else idx.shape[0]))
    for rays in spy.queries:
        o, d, tmin, tmax = (x.detach().numpy()[lanes] for x in
                            (rays.o, rays.d, rays.tmin, rays.tmax))
        live = tmax > tmin
        for lo in range(0, lanes.shape[0], step):
            sl = slice(lo, lo + step)
            out[sl] |= live[sl] & query_borderline(o[sl], d[sl], tmin[sl], tmax[sl], verts, idx,
                                                   spheres)
    return out


def assert_close_frames(acc, ref, scene, cfg, key):
    """The module docstring's rule for one frame: every pixel that differs
    is disputed, and the undisputed pixels are close and keep the mean.
    Scenes of more than 64 triangles re-test only the pixels that differ
    (the float64 pass over every pixel would take minutes); there the mean
    is over the other pixels. Returns the share of pixels found disputed."""
    close = np.isclose(acc, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    dis = np.zeros(close.shape[0], bool)
    differ = np.nonzero(~close)[0]
    if differ.size:
        dis[differ] = disputed(scene, cfg, differ)
        assert dis[differ].all(), (
            f"{key}: pixels {differ[~dis[differ]][:10]} differ and are not disputed")
    if scene.geom is None or scene.geom.indices.shape[0] <= 64:
        rest = np.nonzero(close)[0]
        dis[rest] = disputed(scene, cfg, rest)
    keep = ~dis
    if keep.any():
        assert close[keep].mean() >= 0.99
        assert abs(acc[keep].mean() - ref[keep].mean()) <= 1e-4 * abs(ref[keep].mean())
    return dis.mean()


@pytest.fixture(scope="module")
def port_side(jax_side):
    """Each case's port frames, made once: key -> (scene, cfg, accumulator
    after each of two steps, shader ids the first step's primary rays hit)."""
    cache = {}

    def frames(key):
        if key not in cache:
            side = jax_side["cases"][key]
            scene = convert.scene_from_arrays(side["scene"], "cpu")
            cfg = _port_cfg(side["cfg"])
            st = progressive.init_state(cfg, "cpu")
            accs = []
            with _Spy() as spy:
                progressive.step(scene, cfg, st)
            accs.append(st.accum.numpy().copy())
            progressive.step(scene, cfg, st)
            accs.append(st.accum.numpy().copy())
            assert st.iteration == 2
            first = spy.hits[0]
            cache[key] = (scene, cfg, accs, set(first.shader[first.valid].tolist()))
        return cache[key]

    return frames


@pytest.mark.parametrize("key", list(CASES))
def test_two_steps_match_jax_on_its_buffers(jax_side, port_side, key):
    scene, cfg, accs, _ = port_side(key)
    for acc, ref in zip(accs, jax_side["cases"][key]["accs"]):
        assert np.isfinite(acc).all()
        if key in BACKGROUND:
            assert np.array_equal(acc.view(np.int32), ref.view(np.int32))
        else:
            assert_close_frames(acc, ref, scene, cfg, key)


def test_every_arm_light_and_ambient_lights_a_lane(port_side):
    """Over the cases, the primary rays hit every direct arm (0-7), and the
    Lambertian lanes see every direct light kind and ambient term."""
    arms, lights, ambients = set(), set(), set()
    for key in CASES:
        _, cfg, _, seen = port_side(key)
        arms |= seen
        if 0 in seen:
            lights |= set(cfg.lights)
            ambients.add(cfg.ambient)
    assert set(range(8)) <= arms, arms
    assert set(build.DIRECT_LIGHTS) <= lights, lights
    assert set(build.AMBIENTS) <= ambients, ambients


@pytest.mark.parametrize("size", [32, 450, 512])
def test_jitters_bitwise(jax_side, size):
    for subdivs in range(1, 11):
        a = compute_jitters(1.0 / size, subdivs)
        b = jax_side["jitters"][size, subdivs]
        assert a.shape == b.shape == (subdivs * subdivs, 2) and a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), subdivs


@pytest.mark.parametrize("kind", [tex.ENV_LDR, tex.ENV_RGBE], ids=["ldr", "rgbe"])
@pytest.mark.parametrize("mode", SAMPLERS, ids=lambda m: str(m))
def test_texture_samplers_match_jax(jax_side, kind, mode):
    """The same texels, at rtol 1e-6 (LDR: the same float32 lerp) and 1e-5
    (RGBE: the port takes exp2 in float64 and rounds it, the JAX package
    in float32)."""
    t = tex.TextureBuf(data=torch.as_tensor(_lookup_texture(kind)), kind=kind)
    u, v = (torch.as_tensor(x) for x in _lookup_uv())
    got = tex.sample_nearest(t, u, v) if mode == "nearest" else tex.sample(t, u, v, mode)
    np.testing.assert_allclose(got.numpy(), jax_side["samples"][kind, mode],
                               rtol=1e-6 if kind == tex.ENV_LDR else 1e-5, atol=0)


@pytest.mark.parametrize("key", [k for k in CASES if CASES[k][3] is None])
def test_port_build_matches_jax(jax_side, key):
    """The port's own build of each case: the JAX package's config (after
    the brute-force routing), the same analytic primitives, jitters and
    uniforms, and a mesh exactly where the JAX package has one."""
    side = jax_side["cases"][key]
    js = side["scene"]
    scene, cfg = build_scene(case_desc(key, get_scene), "cpu")
    assert cfg == _port_cfg(side["cfg"])
    assert (scene.geom is None) == (js.geom is None)
    assert (scene.tb is None) == (js.tb is None)
    for part, names in (("spheres", ("center", "radius", "shader", "base_color")),
                        ("planes", ("position", "normal", "shader", "textured")),
                        ("tris", ("verts", "shader", "base_color"))):
        mine, theirs = getattr(scene, part), getattr(js, part)
        if mine is None:
            assert np.asarray(theirs.shader).shape[0] == 0, part
            continue
        for name in names:
            assert np.array_equal(getattr(mine, name).numpy(), getattr(theirs, name)), (part, name)
    if js.jitters is None:
        assert scene.jitters is None
    else:
        assert np.array_equal(scene.jitters.numpy(), js.jitters)
    u = js.uniforms
    assert (scene.uniforms.selection1, scene.uniforms.selection2, scene.uniforms.use_texture) == (
        int(u.selection1), int(u.selection2), int(u.use_texture))
    assert scene.texture is None and js.texture is None  # grass.jpg is missing


def _ref_key(row: str) -> str:
    return row if row in CASES and CASES[row][1] == (32, 32) else f"{row} 32x32"


@pytest.mark.parametrize("row", list(DIRECT_REF))
def test_direct_ref_is_jax_and_met(jax_side, row):
    """``chip_smoke.DIRECT_REF`` is what the JAX package computes now (at
    rtol 1e-6), and the port's own build of the row, rendered as
    ``chip_smoke.py`` renders it on the card, meets it at
    ``DIRECT_RTOL``."""
    key = _ref_key(row)
    assert CASES[key][0] == row and CASES[key][1:] == ((32, 32), None, None, None)
    stats = path_stats(jax_side["cases"][key]["accs"][1])
    for k, v in DIRECT_REF[row].items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-6, err_msg=k)
    scene, cfg = build_scene(case_desc(key, get_scene), "cpu")
    st = progressive.render_progressive(scene, cfg, 2)
    assert path_errors(path_stats(st.accum.numpy()), DIRECT_RTOL, DIRECT_REF[row]) == []


def test_path_frames_still_meet_their_references():
    """Path mode did not move: the port's own 32x32 builds of W8 E3 and W9
    E1 (seeded environment) meet ``CORNELL_REF`` and ``PATH_REF``."""
    desc = with_fixture_model(get_scene("W8 E3 Absorption"))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=32, height=32))
    scene, cfg = build_scene(desc, "cpu")
    stats = path_stats(progressive.render_progressive(scene, cfg, 2).accum.numpy())
    assert path_errors(stats, CORNELL_RTOL, CORNELL_REF) == []
    desc = get_scene("W9 E1 Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=32, height=32))
    scene, cfg = build_scene(desc, "cpu")
    st = progressive.render_progressive(with_seeded_env(scene, desc, "cpu"), cfg, 2)
    assert path_errors(path_stats(st.accum.numpy())) == []


def test_subdivs_one_is_the_zero_jitter_frame(jax_side):
    """One sub-sample at zero jitter is the plain frame bit for bit: W3 E4
    (subdivs 1) rendered with an explicit one-row zero table equals it."""
    side = jax_side["cases"]["W3 E4 texture"]
    scene = convert.scene_from_arrays(side["scene"], "cpu")
    cfg = _port_cfg(side["cfg"])
    assert scene.jitters is None
    plain = integrator.render_sample(scene, cfg)
    one = dataclasses.replace(scene, jitters=torch.zeros((1, 2)))
    assert torch.equal(plain.view(torch.int32), integrator.render_sample(one, cfg).view(torch.int32))


@pytest.mark.parametrize("key", GRAD_KEYS)
def test_grad_scene_refuses_new_direct_configs(jax_side, key):
    """(The name is from when ``grad_scene`` refused these configurations.)
    The configurations it once refused (lights other than
    ``directional_n``, shadow rays, ambients other than ``plain_scaled``,
    continuation shaders, analytic triangles, textures, subdivs > 1, no
    mesh) are differentiated now: on this module's buffers, the gradient
    of each case equals the JAX package's by the checks of
    ``tests/_direct_grad.py`` (leaf by leaf under the mask of disputed
    pixels at rtol 3e-4, the camera and material leaves of the unmasked
    gradient at rtol 1e-3, two runs bitwise)."""
    side = jax_side["grads"][key]
    scene, cfg = convert.scene_from_arrays(side["scene"], "cpu"), _port_cfg(side["cfg"])
    assert G.not_differentiated(scene, cfg) == []
    g = check_case(key, side)
    assert any(x.any() for x in g.values())


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]), sys.argv[2:])

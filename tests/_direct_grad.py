"""Direct-mode gradients against the JAX package: the cases, the JAX side
(a child process) and the port's checks, shared by
``tests/test_torch_direct_grad*.py``.

Each case is a registry row (its Cornell box from
``chip_smoke.with_fixture_model``, or a stand-in mesh from
``chip_smoke.with_standin_mesh``) at a small size, optionally with
``chip_smoke.seeded_texture`` bound as the plane texture on a plane that
``chip_smoke.with_textured_plane`` marks textured (``grass.jpg`` is
missing, and both registries build the W3 plane untextured, so only then
do ``texture.data`` and ``uniforms.uv_scale`` get gradients). The JAX
side builds the scene, renders it once, runs the port's render on the
same buffers (``convert.scene_from_arrays``) and takes the mask of undisputed pixels: those whose radiance agrees at rtol
1e-4 and atol 1e-5 in every channel (``tests/test_torch_direct.py``'s
closeness of a pixel) and none of whose texture lookups' gradients turns
on rounding (``TexelEdges``: near a texel edge, or grazing). It then takes
the JAX package's gradient of the L2 over those pixels and its unmasked
``grad_scene``, every float leaf by its path in the ``Scene`` pytree.

The port's checks (``check_case``):
* every pixel masked for its radiance is disputed: one of its queries
  (closest hit or shadow ray) is borderline under the float64 re-test of
  ``tests/test_torch_direct.py``, so rounding decides it (W6 E2's
  self-shadowing acne at eta 1e-5 is the large case), or the rounding of
  its texture lookup's coordinates can move its sample by as much
  (``TexelNoise``: the far plane, where uv is large);
* the gradient of the masked L2, leaf by leaf, at rtol 3e-4 and an atol of
  1e-4 of the leaf's largest magnitude (``tests/test_torch_grad.py``'s
  tolerances): XLA contracts multiply-adds into FMAs and sums lanes in
  other orders, the port rounds every operation;
* the unmasked ``grad_scene``: the camera and material leaves at rtol
  1e-3, on the cases where no pixel is masked (the masked pixels'
  contributions differ between the packages);
* two runs of ``grad_scene`` bitwise, every leaf finite.

Where the JAX package's gradient is not finite (the Phong lobe on an
analytic primitive, whose shininess is 0: ``jnp.power``'s derivative in
its base at 0 is 0 x 0^-1), the test names those leaves; the port's are
finite (PyTorch's ``pow`` gives 0 there) and the other leaves are
compared.

JAX sides run in child processes (``python tests/_direct_grad.py OUT
KEY...``), at most two at a time: in this JAX version a jitted render in a
process breaks a later ``progressive.step`` there, and the tier-1 command
already runs six workers on eight cores.
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
import torch

from chip_smoke import (FIXTURE_MODELS, seeded_texture, with_fixture_model, with_standin_mesh,
                        with_textured_plane)

from tracer_torch import convert
from tracer_torch.diff import grad as G
from tracer_torch.render import integrator
from tracer_torch.render import texture as tex
from tracer_torch.render.scene import SceneConfig

REPO = Path(__file__).resolve().parents[1]
MASK_RTOL, MASK_ATOL = 1e-4, 1e-5  # the frame tests' closeness of a pixel
TEXEL_EDGE = 1e-4  # texels; see ``TexelEdges``
TAU_ULPS = 2  # float32 ulps of a lookup's coordinate; see ``TexelNoise``
RTOL, ATOL_SCALE = 3e-4, 1e-4
GLOBAL_RTOL = 1e-3
GLOBAL_LEAVES = ("camera.eye", "camera.target", "camera.up", "camera.constant",
                 "camera.aspect", "materials.diffuse", "materials.emission",
                 "materials.specular", "materials.shininess")


def _cases() -> dict:
    """key -> (row, (W, H), texture (mode, uv_scale) or None, stand-in model
    or None, selections or None)."""
    cases = {}
    for r in ("W1 E1", "W1 E2", "W1 E3", "W1 E4", "W1 E5", "W1 E6",
              "W2 E1", "W2 E2", "W2 E3", "W2 E4", "W2 E5", "W3 E1", "W3 E2", "W3 E4"):
        cases[r] = (r, (32, 32), None, None, None)
    cases["W2 E5 glossy+phong"] = ("W2 E5", (32, 32), None, None, (4, 1))
    cases["W2 E5 transparent+normal"] = ("W2 E5", (32, 32), None, None, (7, 5))
    for r in ("W3 E1", "W3 E2", "W3 E4"):
        cases[f"{r} texture"] = (r, (32, 32), (tex.TEX_DEFAULT, (1.5, 2.0)), None, None)
    cases["W3 E4 nearest"] = ("W3 E4", (32, 32), (tex.TEX_NEAREST, (2.0, 2.0)), None, None)
    # 16 sub-samples: the JAX side alone takes about a minute at 16x16.
    cases["W3 E3 texture"] = ("W3 E3", (16, 16), (tex.TEX_DEFAULT, (1.5, 2.0)), None, None)
    for r in ("W5 E4 Cornell Box", "W5 E5 Cornell Box", "W6 E2 Cornell Box",
              "W6 E3 Cornell Box", "W7 E1 Cornell Box", "W7 E2 Cornell Box"):
        cases[r] = (r, (16, 16), None, None, None)
    cases["W6 E1 Bunny"] = ("W6 E1 Bunny", (32, 24), None, None, None)
    cases["W5 E2 bunny"] = ("W5 E2 Teapot", (32, 24), None, "bunny.obj", None)
    cases["W5 E3 bunny"] = ("W5 E3 Teapot", (32, 24), None, "bunny.obj", None)
    return cases


CASES = _cases()


def case_desc(key: str, get):
    """The descriptor of case ``key`` from the registry getter ``get`` (the
    JAX package's or the port's)."""
    row, (w, h), texture, standin, sel = CASES[key]
    desc = get(row)
    if texture is not None:
        desc = with_textured_plane(desc)
    if standin is not None:
        desc = with_standin_mesh(desc, standin)
    elif os.path.basename(desc.model or "") in FIXTURE_MODELS:
        desc = with_fixture_model(desc)
    if sel is not None:
        desc = dataclasses.replace(desc, selection1=sel[0], selection2=sel[1])
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=w, height=h))


def port_cfg(cfg) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(SceneConfig)})


def masked_loss(render, mask):
    """The L2 against target zeros over the pixels of ``mask``."""
    def loss(s):
        img = render(s)
        return (mask[:, None] * img ** 2).sum() / (img.shape[0] * img.shape[1])
    return loss


# fd_check's step along a direction of ones, by leaf class, times the
# leaf's largest magnitude (at least 1): colours and texels enter the loss
# smoothly (quadratically), so a wide step is exact; geometry moves
# silhouettes and shadow edges, so its step is short enough that no pixel's
# hit flips on these frames, and long enough that the float32 rounding of
# the loss (a mean of squares near 0.3) stays near 1% of the difference.
# A shift of every sub-sample sweeps W3 E3's whole horizon, hence the
# jitters' shorter step.
FD_EPS = {"camera.eye": 1e-3, "spheres.center": 3e-4, "tris.verts": 1e-3,
          "geom.vertices": 1e-3, "jitters": 1e-5, "uniforms.uv_scale": 1e-4}
FD_RTOL = 0.08


def fd_probe(scene, cfg, key: str, eps: float | None = None, rtol: float = FD_RTOL,
             direction=None, target=None):
    """``grad.fd_check`` of the L2 against ``target`` (zeros by default)
    along ``direction`` (ones by default) on the leaf ``key``, at a step of
    ``FD_EPS`` (default 1e-2) times the leaf's largest magnitude (at least
    1) unless ``eps`` is given; returns (ad, fd)."""
    from tracer_torch.geometry.device import refresh_tri_table

    def set_(s, x):
        s = G.with_leaves(s, {key: x})
        return dataclasses.replace(s, geom=refresh_tri_table(s.geom)) \
            if key == "geom.vertices" else s

    x = G.leaf(scene, key)
    if eps is None:
        eps = FD_EPS.get(key, 1e-2) * max(1.0, float(x.abs().max()))
    if target is None:
        target = torch.zeros((cfg.width * cfg.height, 3))
    return G.fd_check(scene, cfg, target, lambda s: G.leaf(s, key), set_,
                      torch.ones_like(x) if direction is None else direction, eps=eps, rtol=rtol)


def plane_u0_rays():
    """(o, d) of rays straight down onto the worksheet-3 plane (through the
    origin, tangent -x) at x = 0, where the plane's u is exactly 0: clear of
    the sphere and the triangle."""
    z = np.linspace(1.5, 3.0, 8, dtype=np.float32)
    o = np.stack([np.zeros_like(z), np.ones_like(z), z], axis=-1)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (z.shape[0], 1))
    return o, d


def _jax_plane_u0(scene, cfg):
    """The JAX package's gradient of the sum of the hit uv of
    ``plane_u0_rays`` with respect to the planes' tangent and position."""
    import jax
    import jax.numpy as jnp

    from tracer.kernels.intersect import Rays as JaxRays
    from tracer.render import integrator as jax_integrator
    from tracer.util import replace as jax_replace

    o, d = plane_u0_rays()
    n = o.shape[0]
    rays = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.full(n, cfg.eta, jnp.float32),
                   jnp.full(n, cfg.tmax, jnp.float32))

    def uv_sum(tangent, position):
        planes = jax_replace(scene.planes, tangent=tangent, position=position)
        hit = jax_integrator.trace_closest(jax_replace(scene, planes=planes), cfg, rays)
        return hit.uv.sum()

    g = jax.grad(uv_sum, argnums=(0, 1))(scene.planes.tangent, scene.planes.position)
    return [np.asarray(x) for x in g]


class TexelEdges:
    """Records the plane-texture lookups of a port render and finds the
    pixels whose lookup's gradient turns on rounding:

    * a lookup on a textured plane within ``TEXEL_EDGE`` texels, plus the
      rounding noise of its coordinate (``TAU_ULPS`` float32 ulps of the
      scaled uv, in texels), of a texel edge or of the plane's u = 0 or
      v = 0: there the bilinear weights' kink (the nearest sampler's jump,
      the uv's ``abs``) lies, and which side a lookup falls on turns on
      rounding (XLA contracts ``u * w - 0.5`` into an FMA; the port rounds
      both operations). The radiance is continuous across a bilinear kink,
      so its mask does not see it, but the lane's gradient changes there;
    * a grazing lookup: the hit's t = (p0 - o).n / (d.n) rounds to a
      relative error of ``TAU_ULPS`` ulps over cos(d, n), and its
      derivatives to that over cos^2; where that reaches ``RTOL`` (cos
      below 0.028) the two packages' roundings of the lane's gradient may
      differ by more than the tolerance. At 16x16, one such lane of W3
      E3 (cos 0.0017, t 881) carries most of the camera's gradient."""

    def __enter__(self):
        self.lanes = []
        self.orig = integrator._plane_albedo
        self.trace = integrator.trace_closest
        rays_of = []

        def trace(sc, c, rays, *a, **kw):
            rays_of[:] = [rays]
            return self.trace(sc, c, rays, *a, **kw)

        def spy(scene, cfg, hit):
            mode = scene.uniforms.use_texture
            if cfg.plane_texture and scene.texture is not None and mode != tex.TEX_NONE:
                h, w = scene.texture.data.shape[:2]
                shift = 0.0 if mode == tex.TEX_NEAREST else 0.5
                uv = (hit.uv * scene.uniforms.uv_scale).double()
                near = torch.zeros_like(hit.textured)
                for c, size in ((0, w), (1, h)):
                    f = (uv[:, c] - torch.floor(uv[:, c])) * size - shift
                    noise = TAU_ULPS * 2.0 ** -23 * torch.abs(uv[:, c]) * size
                    near |= torch.abs(f - torch.round(f)) < TEXEL_EDGE + noise
                    # The plane's own kink: uv is |u|, |v| (at u = 0 too).
                    near |= uv[:, c] * size < TEXEL_EDGE
                d = rays_of[0].d.double()
                cos = (d * hit.normal.double()).sum(-1).abs() / d.norm(dim=-1)
                near |= TAU_ULPS * 2.0 ** -23 / cos ** 2 >= RTOL
                self.lanes.append((hit.textured & near).numpy())
            return self.orig(scene, cfg, hit)

        integrator._plane_albedo = spy
        integrator.trace_closest = trace
        return self

    def __exit__(self, *exc):
        integrator._plane_albedo = self.orig
        integrator.trace_closest = self.trace

    def pixels(self, n: int) -> np.ndarray:
        """(n,) bool: the pixels of a frame of n lanes with such a lookup
        in any of its sub-samples."""
        out = np.zeros(n, bool)
        for lanes in self.lanes:
            out |= lanes.reshape(-1, n).any(axis=0)
        return out


class TexelNoise(TexelEdges):
    """Records the plane-texture lookups of a port render and finds the
    pixels whose lookup rounding can move by ``MASK_RTOL``: moving a
    textured lane's scaled uv by ``TAU_ULPS`` float32 ulps (of either
    coordinate, either way) changes its sample, taken in float64, by at
    least ``MASK_RTOL`` of the sample in some channel. Far on the plane uv
    is large (60 and more at the horizon), so its rounding moves the lookup
    by 1e-4 texels and more, and a texture of random texels turns that into
    a radiance difference between the two packages."""

    def __enter__(self):
        self.lanes = []
        self.orig = integrator._plane_albedo
        self.trace = integrator.trace_closest

        def spy(scene, cfg, hit):
            mode = scene.uniforms.use_texture
            if cfg.plane_texture and scene.texture is not None and mode != tex.TEX_NONE:
                t64 = tex.TextureBuf(scene.texture.data.double(), scene.texture.kind)
                uv = (hit.uv * scene.uniforms.uv_scale).double()

                def sample(u, v):
                    return tex.sample(t64, u - torch.floor(u), v - torch.floor(v), mode)

                base = sample(uv[:, 0], uv[:, 1])
                moved = torch.zeros_like(hit.textured)
                for c in (0, 1):
                    for sign in (-1.0, 1.0):
                        w = uv.clone()
                        w[:, c] = w[:, c] * (1.0 + sign * TAU_ULPS * 2.0 ** -23)
                        d = (sample(w[:, 0], w[:, 1]) - base).abs()
                        moved |= (d >= MASK_RTOL * base.abs()).any(dim=-1) & (d > 0).any(dim=-1)
                self.lanes.append((hit.textured & moved).numpy())
            return self.orig(scene, cfg, hit)

        integrator._plane_albedo = spy
        return self

    def pixels(self, n: int) -> np.ndarray:
        """(n,) bool: the pixels of a frame of n lanes with such a lookup
        in any of its sub-samples."""
        out = np.zeros(n, bool)
        for lanes in self.lanes:
            out |= lanes.reshape(-1, n).any(axis=0)
        return out


def jax_gradient_side(scene, cfg) -> dict:
    """The JAX side of one case (see the module docstring) from the JAX
    package's scene and config: its buffers, config, masks and gradients.
    Call only in a child process.

    With k > 1 stratified sub-samples (W3 E3's 16), the JAX package's
    ``render_sample`` is the sum of k one-sub-sample renders divided by k,
    so its gradient is the sum of the k renders' pullbacks of the
    cotangent over k: each is taken by the JAX package's ``vjp`` of a
    render whose jitter table is that one row, compiled once, where the
    gradient of the whole render compiles k unrolled renders (about a
    minute for W3 E3)."""
    import jax
    import jax.numpy as jnp

    from tracer.diff import grad as JG
    from tracer.util import replace as jax_replace

    def float_leaves(g):
        leaves = {jax.tree_util.keystr(p)[1:]: np.asarray(x)
                  for p, x in jax.tree_util.tree_leaves_with_path(g)}
        return {k: x for k, x in leaves.items() if x.dtype.kind == "f"}

    jitters = scene.jitters
    k = 1 if jitters is None else jitters.shape[0]

    @jax.jit
    def pull(s, cot):
        # One sub-sample's radiance and its pullback of ``cot``.
        img, back = jax.vjp(lambda s: JG.render_radiance(s, cfg), s)
        return img, back(cot)[0]

    def sub(i):
        return scene if k == 1 else jax_replace(scene, jitters=jitters[i:i + 1])

    n = cfg.width * cfg.height
    zero = jnp.zeros((n, 3), jnp.float32)
    acc = zero
    for i in range(k):
        acc = acc + pull(sub(i), zero)[0]
    jimg = acc / jnp.float32(k)

    def gradient(mask):
        cot = mask[:, None] * (2.0 * jimg / jimg.size) / jnp.float32(k)
        total = None
        rows = []
        for i in range(k):
            g = pull(sub(i), cot)[1]
            if k > 1:
                rows.append(g.jitters)
                g = jax_replace(g, jitters=None)
            total = g if total is None else jax.tree.map(
                lambda a, b: a if a.dtype == jax.dtypes.float0 else a + b, total, g)
        if k > 1:
            total = jax_replace(total, jitters=jnp.concatenate(rows, axis=0))
        return total

    arrays = jax.tree.map(np.asarray, scene)
    full = gradient(jnp.ones(n, jnp.float32))
    jimg = np.asarray(jimg)
    with torch.no_grad(), TexelEdges() as edges:
        pimg = G.render_radiance(convert.scene_from_arrays(arrays, "cpu"), port_cfg(cfg)).numpy()
    edge = edges.pixels(n)
    mask = np.isclose(pimg, jimg, rtol=MASK_RTOL, atol=MASK_ATOL).all(-1) & ~edge
    masked = full if mask.all() else gradient(jnp.asarray(mask.astype(np.float32)))
    return dict(scene=arrays, cfg=cfg, mask=mask, edge=edge, masked=float_leaves(masked),
                grads=float_leaves(full))


def _write_jax_side(out: Path, keys: list) -> None:
    """The JAX side of the cases ``keys`` (see the module docstring),
    pickled to ``out``."""
    from _share_cores import share_cores

    share_cores()
    import jax
    import jax.numpy as jnp

    from tracer.render import texture as jax_tex
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene
    from tracer.util import replace as jax_replace

    jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
    side = {}
    for key in keys:
        scene, cfg = jax_build_scene(case_desc(key, jax_get_scene))
        texture = CASES[key][2]
        if texture is not None:
            # Its own name: this JAX version would reuse the program
            # compiled for the same config without a texture.
            cfg = dataclasses.replace(cfg, name=f"{cfg.name} (seeded texture)")
            mode, uv_scale = texture
            scene = jax_replace(
                scene, texture=jax_tex.TextureBuf(data=jnp.asarray(seeded_texture()),
                                                  kind=jax_tex.ENV_LDR),
                uniforms=jax_replace(scene.uniforms, use_texture=jnp.int32(mode),
                                     uv_scale=jnp.asarray(uv_scale, jnp.float32)))
        side[key] = jax_gradient_side(scene, cfg)
        if key == "W3 E1":
            side["plane u0"] = _jax_plane_u0(scene, cfg)
    with open(out, "wb") as f:
        pickle.dump(side, f)


def jax_sides(tmp: Path, groups: list) -> dict:
    """The JAX side of each group of keys, one child process per group, two
    at a time; merged into one dict keyed by case."""
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    env = {**os.environ, "PYTHONPATH": path, "TRACER_NO_SCENE_CACHE": "1"}
    outs = [tmp / f"jax_grad_{i}.pkl" for i in range(len(groups))]

    def run(i):
        return subprocess.run([sys.executable, __file__, str(outs[i]), *groups[i]], cwd=REPO,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                              env=env)

    side: dict = {}
    with ThreadPoolExecutor(2) as pool:
        for i, done in enumerate(pool.map(run, range(len(groups)))):
            if done.returncode:
                raise RuntimeError(f"the JAX side of {groups[i]} failed:\n{done.stderr[-4000:]}")
            with open(outs[i], "rb") as f:
                side.update(pickle.load(f))
    return side


def port_scene(side):
    return convert.scene_from_arrays(side["scene"], "cpu"), port_cfg(side["cfg"])


def check_case(key: str, side, not_finite_in_jax=()) -> dict:
    """The port against the JAX side of case ``key`` (see the module
    docstring); returns the port's unmasked ``grad_scene`` as arrays.
    ``not_finite_in_jax``: the leaves that the JAX package's gradient has
    non-finite (held as such, and finite in the port's); every other leaf
    is finite in both and compared."""
    from test_torch_direct import disputed

    scene, cfg = port_scene(side)
    mask, edge = side["mask"], side["edge"]
    # At most about the horizon's row of pixels (grazing lookups) and a few
    # more on texel edges.
    assert edge.mean() <= 0.1, f"{key}: {int(edge.sum())} pixels on texel edges or grazing"
    masked = np.nonzero(~mask & ~edge)[0]
    if masked.size:
        with torch.no_grad(), TexelNoise() as noise:
            G.render_radiance(scene, cfg)
        dis = noise.pixels(mask.shape[0])[masked]
        dis[~dis] = disputed(scene, cfg, masked[~dis])
        assert dis.all(), f"{key}: pixels {masked[~dis][:10]} differ and are not disputed"
    got = convert.grads_to_arrays(G.scene_grads(scene, masked_loss(
        lambda s: G.render_radiance(s, cfg), torch.as_tensor(mask.astype(np.float32)))))
    want = side["masked"]
    bad = sorted(k for k, x in side["grads"].items() if not np.isfinite(x).all())
    assert bad == sorted(not_finite_in_jax), f"{key}: the JAX package's non-finite leaves {bad}"
    for k, g in got.items():
        assert np.isfinite(g).all(), k
        if k in not_finite_in_jax:
            continue
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        np.testing.assert_allclose(g, want[k], rtol=RTOL, atol=ATOL_SCALE * scale,
                                   err_msg=f"{key} {k}")
    for k in set(want) - set(got):
        assert not want[k].any(), f"{key}: {k} is nonzero in the JAX package's gradient"

    target = torch.zeros((cfg.width * cfg.height, 3))
    g1 = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    g2 = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    assert g1.keys() == g2.keys() == got.keys()
    for k in g1:
        assert np.isfinite(g1[k]).all(), k
        assert np.array_equal(g1[k].view(np.int32), g2[k].view(np.int32)), f"{key} {k}"
    for k in GLOBAL_LEAVES if mask.all() else ():
        if k in g1 and k not in not_finite_in_jax:
            want_k = side["grads"][k]
            np.testing.assert_allclose(g1[k], want_k, rtol=GLOBAL_RTOL,
                                       atol=ATOL_SCALE * float(np.abs(want_k).max()),
                                       err_msg=f"{key} {k}")
    return g1


if __name__ == "__main__":
    _write_jax_side(Path(sys.argv[1]), sys.argv[2:])

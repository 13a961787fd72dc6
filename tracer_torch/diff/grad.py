"""Differentiable rendering: losses, scene gradients, FD checks (port of
``tracer.diff.grad``).

The forward transport (``tracer_torch.render.integrator``) is
differentiable end to end: the traversal returns integer ids under
``no_grad`` and every hit attribute is re-derived from them, so reverse
mode gives pixel gradients with respect to the camera, the mesh vertices
and normals, the materials, the analytic spheres and planes and the
environment map, through every bounce of path mode (next-event
estimation, the mirror, the dielectric, Russian roulette and the firefly
clamp included). Discrete events (which triangle a pixel sees, roulette
and Fresnel picks, light draws) are held fixed by the sample, as in the
JAX package: the estimator is biased at silhouettes.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from tracer_torch.geometry.device import SHADER_LAMBERTIAN, GeometryBuffers, MaterialTable, Planes
from tracer_torch.render import integrator
from tracer_torch.render.camera import Camera
from tracer_torch.render.scene import Scene, SceneConfig, Spheres
from tracer_torch.render.texture import TextureBuf

# The float leaves of a scene, by their path in the JAX package's ``Scene``
# pytree: what ``grad_scene`` differentiates. The spheres, planes and
# environment map are leaves only where the scene has them.
FLOAT_LEAVES = (
    "camera.eye", "camera.target", "camera.up", "camera.constant", "camera.aspect",
    "geom.vertices", "geom.normals", "geom.tri_table",
    "materials.diffuse", "materials.emission", "materials.specular",
    "materials.shininess", "materials.ior",
    "spheres.center", "spheres.radius", "spheres.base_color", "spheres.ior",
    "spheres.extinction",
    "planes.position", "planes.normal", "planes.tangent", "planes.binormal",
    "planes.base_color",
    "env.data",
)


def leaf(obj, key: str):
    """The leaf at ``key`` (for example ``"camera.eye"``) of a scene or of
    a scene gradient; ``None`` where the part (``spheres``, ``planes``,
    ``env``) is absent."""
    part, name = key.split(".")
    part = getattr(obj, part)
    return None if part is None else getattr(part, name)


def float_leaves(scene) -> tuple:
    """The keys of ``FLOAT_LEAVES`` that ``scene`` has."""
    return tuple(k for k in FLOAT_LEAVES if leaf(scene, k) is not None)


def _parts(leaves: dict) -> dict:
    """{"camera.eye": x, ...} -> {"camera": {"eye": x, ...}, ...}."""
    parts: dict = {}
    for key, x in leaves.items():
        part, name = key.split(".")
        parts.setdefault(part, {})[name] = x
    return parts


def with_leaves(scene: Scene, leaves: dict) -> Scene:
    """``scene`` with the leaves named in ``leaves`` replaced."""
    return replace(scene, **{part: replace(getattr(scene, part), **kw)
                             for part, kw in _parts(leaves).items()})


def not_differentiated(scene: Scene, cfg: SceneConfig) -> list[str]:
    """What of this scene and configuration the gradients do not cover yet
    ([] when they do): direct mode only as ``project.wgsl`` configures it
    (the ``directional_n`` light, no shadow rays, the ``plain_scaled``
    ambient term, the Lambertian, one sample per pixel), and in either mode
    a triangle mesh, no analytic triangles and no plane texture."""
    why = []
    if cfg.mode == "direct":
        if any(k != "directional_n" for k in cfg.lights):
            why.append(f"lights {cfg.lights}")
        if cfg.shadows:
            why.append("shadow rays")
        if cfg.ambient != "plain_scaled":
            why.append(f"ambient {cfg.ambient!r}")
        if set(cfg.possible_shaders) - {SHADER_LAMBERTIAN}:
            why.append(f"shaders {cfg.possible_shaders} in direct mode")
        if cfg.subdivs > 1 or scene.jitters is not None:
            why.append(f"subdivs {cfg.subdivs}")
    if scene.geom is None:
        why.append("no triangle mesh")
    if scene.tris is not None:
        why.append("analytic triangles")
    if scene.texture is not None or cfg.plane_texture:
        why.append("plane textures")
    return why


def _check_differentiated(scene: Scene, cfg: SceneConfig) -> None:
    why = not_differentiated(scene, cfg)
    if why:
        raise NotImplementedError(
            f"gradients of {cfg.name or 'this scene'!r} are not ported: " + "; ".join(why))


def _diffable(cfg: SceneConfig) -> SceneConfig:
    """Gradients take the ``scan`` bounce loop, as in the JAX package."""
    return cfg if cfg.loop == "scan" else replace(cfg, loop="scan")


def render_radiance(scene: Scene, cfg: SceneConfig, iteration: int = 0):
    """(N, 3) linear radiance for one sample pass at ``iteration`` (the
    ``iteration`` uniform seeds path mode's random streams)."""
    return integrator.render_sample(integrator.with_iteration(scene, iteration), _diffable(cfg))


def render_mean(scene: Scene, cfg: SceneConfig, num_samples: int = 1):
    """Mean radiance over ``num_samples`` passes at iterations 0, 1, ..."""
    acc = torch.zeros((cfg.height * cfg.width, 3), dtype=torch.float32, device=scene.device)
    for it in range(num_samples):
        acc = acc + render_radiance(scene, cfg, it)
    return acc / torch.tensor(float(num_samples), device=scene.device)


def l2_loss(scene: Scene, cfg: SceneConfig, target, num_samples: int = 1):
    return torch.mean((render_mean(scene, cfg, num_samples) - target) ** 2)


def scene_grads(scene: Scene, loss_fn) -> Scene:
    """Gradient of ``loss_fn(scene)`` with respect to every float leaf of
    the scene, as a ``Scene`` of gradients (see ``grad_scene``)."""
    keys = float_leaves(scene)
    # Fresh leaves on the same storage; the derived table takes no gradient.
    leaves = {k: leaf(scene, k).detach().requires_grad_(k != "geom.tri_table") for k in keys}
    wrt = [k for k in keys if leaves[k].requires_grad]
    with torch.enable_grad():
        loss = loss_fn(with_leaves(scene, leaves))
        grads = torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)
    out = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(wrt, grads)}
    out["geom.tri_table"] = torch.zeros_like(leaves["geom.tri_table"])
    parts = _parts(out)
    sp, pl = parts.get("spheres"), parts.get("planes")
    return Scene(
        camera=Camera(**parts["camera"]),
        uniforms=None,
        geom=GeometryBuffers(indices=None, mat_ids=None, **parts["geom"]),
        materials=MaterialTable(illum=None, **parts["materials"]),
        light_indices=None,
        tb=None,
        spheres=None if sp is None else Spheres(shader=None, **sp),
        planes=None if pl is None else Planes(shader=None, textured=None, **pl),
        env=None if scene.env is None else TextureBuf(data=out["env.data"], kind=scene.env.kind),
    )


def grad_scene(scene: Scene, cfg: SceneConfig, target, num_samples: int = 1) -> Scene:
    """Gradient of the L2 loss with respect to every float leaf of the scene.

    Returns a ``Scene`` of gradients: camera eye, target, up, constant and
    aspect; geometry vertices and normals (``tri_table`` is derived data
    and gets zeros); materials diffuse, emission, specular, shininess and
    ior; where the scene has them, the spheres' center, radius, base colour,
    ior and extinction, the planes' position, normal, tangent, binormal and
    base colour, and the environment map's texels. Leaves the loss does not
    reach get zeros; integer leaves, the uniforms and the accel structure
    are ``None``. Raises ``NotImplementedError`` for what
    ``not_differentiated`` lists.
    """
    _check_differentiated(scene, cfg)
    return scene_grads(scene, lambda s: l2_loss(s, cfg, target, num_samples))


def directional_derivative_ad(scene, cfg, target, get, set_, direction,
                              num_samples: int = 1) -> float:
    """AD directional derivative of the loss along ``direction`` applied to
    the leaf that ``get``/``set_`` address."""
    _check_differentiated(scene, cfg)
    theta = torch.zeros((), dtype=torch.float32, device=scene.device, requires_grad=True)
    with torch.enable_grad():
        moved = get(scene).detach() + theta * direction
        loss = l2_loss(set_(scene, moved), cfg, target, num_samples)
        (g,) = torch.autograd.grad(loss, theta)
    return float(g)


def directional_derivative_fd(scene, cfg, target, get, set_, direction,
                              eps: float = 1e-3, num_samples: int = 1) -> float:
    """Central finite difference along the same direction (the same random
    streams on both sides, so the estimates' noise cancels)."""

    def loss_of(theta: float) -> float:
        moved = get(scene).detach() + theta * direction
        with torch.no_grad():
            return float(l2_loss(set_(scene, moved), cfg, target, num_samples))

    return (loss_of(eps) - loss_of(-eps)) / (2.0 * eps)


def fd_check(scene, cfg, target, get, set_, direction, eps=1e-3, num_samples: int = 1,
             rtol=0.08, atol=1e-7):
    """Raise ``AssertionError`` unless the AD and FD directional derivatives
    agree; returns both. A ``set_`` that moves vertices must call
    ``refresh_tri_table``."""
    ad = directional_derivative_ad(scene, cfg, target, get, set_, direction, num_samples)
    fd = directional_derivative_fd(scene, cfg, target, get, set_, direction, eps, num_samples)
    denom = max(abs(ad), abs(fd), atol)
    if not (abs(ad - fd) / denom <= rtol or abs(ad - fd) <= atol):
        raise AssertionError(f"gradient check failed: ad={ad:.6g} fd={fd:.6g}")
    return ad, fd

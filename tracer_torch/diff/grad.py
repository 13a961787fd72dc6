"""Differentiable rendering: losses, scene gradients, FD checks (port of
``tracer.diff.grad``).

The forward transport (``tracer_torch.render.integrator``) is
differentiable end to end: the traversal returns integer ids under
``no_grad`` and every hit attribute is re-derived from them, so reverse
mode gives pixel gradients with respect to the camera, the mesh vertices
and normals, and the materials. Visibility (which triangle a pixel sees)
is held fixed by the sample, as in the JAX package: the estimator is
biased at silhouettes.

Only the single-bounce loop is ported: ``grad_scene`` raises
``NotImplementedError`` for scenes that can spawn a continuation ray
(single-bounce scenes do not need the JAX package's ``scan`` loop).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from tracer_torch.geometry.device import GeometryBuffers, MaterialTable
from tracer_torch.render import integrator
from tracer_torch.render.camera import Camera
from tracer_torch.render.scene import Scene, SceneConfig

# The float leaves of a scene, by their path in the JAX package's ``Scene``
# pytree: what ``grad_scene`` differentiates.
FLOAT_LEAVES = (
    "camera.eye", "camera.target", "camera.up", "camera.constant", "camera.aspect",
    "geom.vertices", "geom.normals", "geom.tri_table",
    "materials.diffuse", "materials.emission", "materials.specular",
    "materials.shininess", "materials.ior",
)


def leaf(obj, key: str):
    """The leaf at ``key`` (for example ``"camera.eye"``) of a scene or of
    a scene gradient."""
    part, name = key.split(".")
    return getattr(getattr(obj, part), name)


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


def _check(cfg: SceneConfig) -> None:
    if not integrator._single_bounce(cfg):
        raise NotImplementedError("only the single-bounce loop is ported")


def render_radiance(scene: Scene, cfg: SceneConfig):
    """(N, 3) linear radiance for one sample pass. The ported direct mode
    draws no random numbers, so one pass is the whole estimate."""
    _check(cfg)
    return integrator.render_sample(scene, cfg)


def l2_loss(scene: Scene, cfg: SceneConfig, target):
    return torch.mean((render_radiance(scene, cfg) - target) ** 2)


def grad_scene(scene: Scene, cfg: SceneConfig, target) -> Scene:
    """Gradient of the L2 loss with respect to every float leaf of the scene.

    Returns a ``Scene`` of gradients: camera eye, target, up, constant and
    aspect; geometry vertices and normals (``tri_table`` is derived data
    and gets zeros); materials diffuse, emission, specular, shininess and
    ior. Leaves the loss does not reach get zeros; integer leaves, the
    uniforms and the accel structure are ``None``.
    """
    _check(cfg)
    # Fresh leaves on the same storage; the derived table takes no gradient.
    leaves = {k: leaf(scene, k).detach().requires_grad_(k != "geom.tri_table")
              for k in FLOAT_LEAVES}
    wrt = [k for k in FLOAT_LEAVES if leaves[k].requires_grad]
    with torch.enable_grad():
        loss = l2_loss(with_leaves(scene, leaves), cfg, target)
        grads = torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)
    out = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(wrt, grads)}
    out["geom.tri_table"] = torch.zeros_like(leaves["geom.tri_table"])
    parts = _parts(out)
    return Scene(
        camera=Camera(**parts["camera"]),
        uniforms=None,
        geom=GeometryBuffers(indices=None, mat_ids=None, **parts["geom"]),
        materials=MaterialTable(illum=None, **parts["materials"]),
        light_indices=None,
        tb=None,
    )


def directional_derivative_ad(scene, cfg, target, get, set_, direction) -> float:
    """AD directional derivative of the loss along ``direction`` applied to
    the leaf that ``get``/``set_`` address."""
    theta = torch.zeros((), dtype=torch.float32, device=scene.device, requires_grad=True)
    with torch.enable_grad():
        moved = get(scene).detach() + theta * direction
        loss = l2_loss(set_(scene, moved), cfg, target)
        (g,) = torch.autograd.grad(loss, theta)
    return float(g)


def directional_derivative_fd(scene, cfg, target, get, set_, direction,
                              eps: float = 1e-3) -> float:
    """Central finite difference along the same direction."""

    def loss_of(theta: float) -> float:
        moved = get(scene).detach() + theta * direction
        with torch.no_grad():
            return float(l2_loss(set_(scene, moved), cfg, target))

    return (loss_of(eps) - loss_of(-eps)) / (2.0 * eps)


def fd_check(scene, cfg, target, get, set_, direction, eps=1e-3, rtol=0.08, atol=1e-7):
    """Raise ``AssertionError`` unless the AD and FD directional derivatives
    agree; returns both. A ``set_`` that moves vertices must call
    ``refresh_tri_table``."""
    ad = directional_derivative_ad(scene, cfg, target, get, set_, direction)
    fd = directional_derivative_fd(scene, cfg, target, get, set_, direction, eps)
    denom = max(abs(ad), abs(fd), atol)
    if not (abs(ad - fd) / denom <= rtol or abs(ad - fd) <= atol):
        raise AssertionError(f"gradient check failed: ad={ad:.6g} fd={fd:.6g}")
    return ad, fd

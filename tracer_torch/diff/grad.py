"""Differentiable rendering: losses, scene gradients, FD checks (port of
``tracer.diff.grad``).

The forward transport (``tracer_torch.render.integrator``) is
differentiable end to end, in both modes and on every registry row: the
traversal returns integer ids under ``no_grad`` and every hit attribute
is re-derived from them, so reverse mode gives pixel gradients with
respect to the camera, the mesh vertices and normals, the materials, the
analytic spheres, planes and triangles, the environment map, the plane
texture and its ``uv_scale``, and direct mode's stratified jitters:
through every direct arm and light (shadow rays included) and every
bounce of path mode (next-event estimation, the mirror, the dielectric,
Russian roulette and the firefly clamp included). Discrete events (which
triangle a pixel sees, which lanes a shadow ray blocks, roulette and
Fresnel picks, light draws) are held fixed by the sample, as in the JAX
package: the estimator is biased at silhouettes and shadow edges.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from tracer_torch import obs
from tracer_torch.geometry.device import AnalyticTriangles, GeometryBuffers, MaterialTable, Planes
from tracer_torch.math import vec
from tracer_torch.render import integrator
from tracer_torch.render.camera import Camera
from tracer_torch.render.scene import Scene, SceneConfig, Spheres, Uniforms
from tracer_torch.render.texture import TextureBuf

# The float leaves of a scene, by their path in the JAX package's ``Scene``
# pytree: what ``grad_scene`` differentiates. The mesh, spheres, planes,
# analytic triangles, environment map, plane texture and jitters are leaves
# only where the scene has them.
FLOAT_LEAVES = (
    "camera.eye", "camera.target", "camera.up", "camera.constant", "camera.aspect",
    "uniforms.uv_scale",
    "geom.vertices", "geom.normals", "geom.tri_table",
    "materials.diffuse", "materials.emission", "materials.specular",
    "materials.shininess", "materials.ior",
    "spheres.center", "spheres.radius", "spheres.base_color", "spheres.ior",
    "spheres.extinction",
    "planes.position", "planes.normal", "planes.tangent", "planes.binormal",
    "planes.base_color",
    "tris.verts", "tris.base_color",
    "env.data", "texture.data", "jitters",
)


def leaf(obj, key: str):
    """The leaf at ``key`` (for example ``"camera.eye"`` or ``"jitters"``)
    of a scene or of a scene gradient; ``None`` where the part is absent."""
    part, _, name = key.rpartition(".")
    if part:
        obj = getattr(obj, part)
    return None if obj is None else getattr(obj, name)


def float_leaves(scene) -> tuple:
    """The keys of ``FLOAT_LEAVES`` that ``scene`` has."""
    return tuple(k for k in FLOAT_LEAVES if leaf(scene, k) is not None)


def _parts(leaves: dict) -> dict:
    """{"camera.eye": x, "jitters": j, ...} -> {"camera": {"eye": x, ...},
    "": {"jitters": j}}."""
    parts: dict = {}
    for key, x in leaves.items():
        part, _, name = key.rpartition(".")
        parts.setdefault(part, {})[name] = x
    return parts


def with_leaves(scene: Scene, leaves: dict) -> Scene:
    """``scene`` with the leaves named in ``leaves`` replaced."""
    parts = _parts(leaves)
    top = parts.pop("", {})
    return replace(scene, **top, **{part: replace(getattr(scene, part), **kw)
                                    for part, kw in parts.items()})


def not_differentiated(scene: Scene, cfg: SceneConfig) -> list[str]:
    """What of this configuration the gradients do not cover ([] when they
    do, as for every row of the registry under every traversal): what the
    renderer itself does not serve (``scenes.build.unsupported``, for
    example a direct-mode light kind outside ``DIRECT_LIGHTS``). It guards
    configurations made outside the registry."""
    from tracer_torch.scenes.build import unsupported

    return unsupported(None, cfg)


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
    acc = torch.zeros((integrator.lanes(scene, cfg), 3), dtype=torch.float32,
                      device=scene.device)
    for it in range(num_samples):
        acc = acc + render_radiance(scene, cfg, it)
    return vec.div(acc, float(num_samples))


def l2_loss(scene: Scene, cfg: SceneConfig, target, num_samples: int = 1):
    return torch.mean((render_mean(scene, cfg, num_samples) - target) ** 2)


def scene_grads(scene: Scene, loss_fn) -> Scene:
    """Gradient of ``loss_fn(scene)`` with respect to every float leaf of
    the scene, as a ``Scene`` of gradients (see ``grad_scene``)."""
    return _grad_scene_of(scene, _leaf_grads(scene, loss_fn))


def _allocated(device) -> int:
    """Bytes the caching allocator holds for tensors on ``device`` (a host
    counter: no sync); 0 off the card."""
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def _leaf_grads(scene: Scene, loss_fn) -> dict:
    """{key: gradient} of ``loss_fn(scene)`` over ``float_leaves(scene)``.
    Adds to the counter ``grad.held_bytes`` the device memory the forward
    leaves allocated for the backward (0 off the card)."""
    keys = float_leaves(scene)
    # Fresh leaves on the same storage; the derived table takes no gradient.
    leaves = {k: leaf(scene, k).detach().requires_grad_(k != "geom.tri_table") for k in keys}
    wrt = [k for k in keys if leaves[k].requires_grad]
    before = _allocated(scene.device)
    with torch.enable_grad():
        with obs.span("grad.forward"):
            loss = loss_fn(with_leaves(scene, leaves))
        obs.count("grad.held_bytes", _allocated(scene.device) - before)
        # A frame of background alone (W1 E1-E3) reaches no leaf.
        with obs.span("grad.backward"):
            grads = torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True) \
                if loss.requires_grad else [None] * len(wrt)
    out = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(wrt, grads)}
    if "geom.tri_table" in leaves:
        out["geom.tri_table"] = torch.zeros_like(leaves["geom.tri_table"])
    return {k: out[k] for k in keys}


def _grad_scene_of(scene: Scene, out: dict) -> Scene:
    """The ``Scene`` of gradients that ``out`` ({key: gradient}) holds."""
    parts = _parts(out)
    geom, mats, sp, pl, tr = (parts.get(p) for p in ("geom", "materials", "spheres", "planes",
                                                       "tris"))
    return Scene(
        camera=Camera(**parts["camera"]),
        uniforms=Uniforms(selection1=None, selection2=None, use_texture=None,
                          iteration=None, **parts.get("uniforms", {})),
        geom=None if geom is None else GeometryBuffers(indices=None, mat_ids=None, **geom),
        materials=None if mats is None else MaterialTable(illum=None, **mats),
        light_indices=None,
        tb=None,
        spheres=None if sp is None else Spheres(shader=None, **sp),
        planes=None if pl is None else Planes(shader=None, textured=None, **pl),
        tris=None if tr is None else AnalyticTriangles(shader=None, **tr),
        env=None if scene.env is None else TextureBuf(data=out["env.data"], kind=scene.env.kind),
        texture=None if scene.texture is None else TextureBuf(data=out["texture.data"],
                                                              kind=scene.texture.kind),
        jitters=out.get("jitters"),
    )


def grad_scene(scene: Scene, cfg: SceneConfig, target, num_samples: int = 1) -> Scene:
    """Gradient of the L2 loss with respect to every float leaf of the scene.

    Returns a ``Scene`` of gradients: camera eye, target, up, constant and
    aspect; ``uniforms.uv_scale``; where the scene has them, the geometry's
    vertices and normals (``tri_table`` is derived data and gets zeros),
    the materials' diffuse, emission, specular, shininess and ior, the
    spheres' center, radius, base colour, ior and extinction, the planes'
    position, normal, tangent, binormal and base colour, the analytic
    triangles' vertices and base colour, the environment map's and the
    plane texture's texels, and the jitters. Leaves the loss does not reach
    get zeros; integer leaves and the accel structures are ``None``. Raises
    ``NotImplementedError`` for what ``not_differentiated`` lists.
    """
    _check_differentiated(scene, cfg)
    return scene_grads(scene, lambda s: l2_loss(s, cfg, target, num_samples))


def grad_scene_sharded(scene: Scene, cfg: SceneConfig, target, mesh,
                       num_samples: int = 1) -> Scene:
    """``grad_scene`` over the ranks of ``mesh`` (a
    ``tracer_torch.parallel.shard.RayMesh``; the counterpart of the JAX
    package's ``grad_scene_jit`` on replicated inputs). Each rank renders
    its band of the frame (``shard.band_of``) and differentiates its share
    of the L2 loss, the band's mean scaled by its share of the frame's
    elements, so the shares sum to the loss over the whole frame; kernel B2
    places the band's vertex cotangents. Every rank's leaves are then
    summed with one ``all_reduce`` over one flat buffer, in
    ``FLOAT_LEAVES`` order, and every rank returns the sum. A rank with an
    empty band contributes zeros. ``scene`` must be the same on every rank
    (``shard.replicate_scene``) and ``target`` the whole frame's (H*W, 3).
    One rank gives ``grad_scene``'s gradient bit for bit; more ranks sum
    in another order (no float atomics are added: two runs at one world
    size agree bit for bit)."""
    import torch.distributed as dist

    from tracer_torch.parallel import shard

    _check_differentiated(scene, cfg)
    row0, rows = shard.band_of(cfg, mesh)
    keys = float_leaves(scene)
    if rows:
        lo, hi = row0 * cfg.width, (row0 + rows) * cfg.width
        share = float(rows) / float(cfg.height)  # exactly 1.0 for the whole frame
        out = _leaf_grads(replace(scene, band=(row0, rows)),
                          lambda s: l2_loss(s, cfg, target[lo:hi], num_samples) * share)
    else:
        out = {k: torch.zeros_like(leaf(scene, k)) for k in keys}
    flat = torch.cat([out[k].reshape(-1) for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    sizes = [out[k].numel() for k in keys]
    out = {k: g.view_as(out[k]) for k, g in zip(keys, torch.split(flat, sizes))}
    return _grad_scene_of(scene, out)


def directional_derivative_ad(scene, cfg, target, get, set_, direction,
                              num_samples: int = 1) -> float:
    """AD directional derivative of the loss along ``direction`` applied to
    the leaf that ``get``/``set_`` address."""
    _check_differentiated(scene, cfg)
    theta = torch.zeros((), dtype=torch.float32, device=scene.device, requires_grad=True)
    with torch.enable_grad():
        moved = get(scene).detach() + theta * direction
        loss = l2_loss(set_(scene, moved), cfg, target, num_samples)
        if not loss.requires_grad:  # the loss does not reach the leaf
            return 0.0
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

"""Wavefront integrator (port of ``tracer.render.integrator``): direct mode
and path mode over analytic spheres, planes and triangles and a triangle
mesh.

The whole W*H pixel wavefront advances together, one bounce at a time;
every lane evaluates the shader arms its scene can produce, and masks
select the results, as in the JAX package.

* Direct mode (worksheets 1-7 and the ``Project:`` rows): the closest hit
  over the analytic primitives and the mesh (the flat treelet engine, or
  the brute-force engine for meshes of 64 triangles or fewer), the
  background colour on misses, and the direct shader arms: the Lambertian
  under the ``point_w1``, ``directional``, ``directional_n`` and
  ``area_all`` lights (shadow rays through ``trace_occluded``) with the
  ``mix``, ``mix_ka``, ``plain`` and ``plain_scaled`` ambient terms, Phong,
  the mirror, the deterministic transmit (glossy = Phong + transmit), the
  normal and base-colour arms, and textured planes. Each pixel averages
  ``scene.jitters``' stratified sub-samples. Scenes whose shaders cannot
  spawn a continuation ray take exactly one bounce (``_single_bounce``);
  the others run the same bounce loop as path mode.
* Path mode (``W7 E3``, ``W8 E1``-``E3``, ``W9 E1``/``E2``): per-pixel
  random jitter and streams (``math.rng``), a multi-bounce ``while`` or
  ``scan`` loop that stops when every lane is done, the mesh through the
  packet engine or the brute-force engine, the environment map (or the
  background colour) on misses, and four shaders: the path-traced
  Lambertian (one-sample next-event estimation over the emissive triangles
  with a shadow ray, emission gating, and Russian roulette with
  cosine-hemisphere continuation), the mirror, the stochastic Fresnel
  dielectric with optional Beer-Lambert absorption, and the holdout, whose
  ambient-occlusion probe is a mesh any-hit query.

The path is differentiable as in the JAX package: the traversal runs on
detached inputs under ``no_grad`` and returns integer ids, and every hit
attribute is re-derived from the winning id (a row fetch, then the Möller
test of that one triangle), so gradients reach the camera, the vertices and
normals, the materials, the analytic spheres and planes and the environment
map. Where the JAX package fetches rows by a one-hot product, so does the
port, because a gradient flows through them and a product's backward is a
product (deterministic on the card) where a gather's would be a scatter:
the material rows, the triangle rows of meshes of at most 128 triangles
(from a table built from the vertices and normals inside the call) and the
light table of at most 64 emissive triangles. Larger meshes fetch their
rows with ``fetch_tri_rows``, whose backward is kernel B2. TF32 is off
(``tracer_torch/__init__.py``), so every such float32 product is an exact
selection on every device.

Path mode's ``scan`` loop (the JAX package's differentiable one) is the
``while`` loop with optional rematerialisation of each bounce
(``cfg.remat``): autograd records a Python loop, so it too stops once every
lane is done, and the bounces it skips would add nothing but zeros.

On the card, a path-mode bounce on the brute-force engine reads nothing
back to the host, so ``_loop`` captures it once as a CUDA graph and
replays it (``_BounceGraph``), with autograd and spans off: one host launch
a bounce where the eager bounce makes several hundred, the same kernels
on the same inputs, so the same frame bit for bit. The constants the
bounce divides or fills by are made once (``vec.const``), since a fresh
``torch.tensor`` on the card is a blocking copy from the host.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, fields, replace

import torch

from tracer_torch import obs
from tracer_torch.accel import bsp as bsp_mod
from tracer_torch.accel import flat, packet, traverse, wide
from tracer_torch.geometry.device import (
    SHADER_BASECOLOR,
    SHADER_GLOSSY,
    SHADER_HOLDOUT,
    SHADER_LAMBERTIAN,
    SHADER_MIRROR,
    SHADER_NORMAL,
    SHADER_PHONG,
    SHADER_TRANSMIT,
    SHADER_TRANSPARENT,
    fetch_tri_rows,
)
from tracer_torch.kernels import intersect
from tracer_torch.kernels.intersect import Rays
from tracer_torch.math import rng, sampling, vec
from tracer_torch.render import texture as tex
from tracer_torch.render.camera import camera_rays, pixel_uv
from tracer_torch.render.scene import (
    FROM_SELECTION1,
    FROM_SELECTION2,
    Scene,
    SceneConfig,
    Uniforms,
)

PI = 3.14159265359  # rounded to float32 where it meets a float32 tensor
# Divisions by Python numbers go through ``vec.div``, so the same frame
# rounds the same way on the CPU and on the card.
ERROR_COLOR = (0.7, 0.0, 0.7)


@dataclass(frozen=True)
class Hit:
    """Per-lane hit record (the reference ``HitRecord``, w9e2.wgsl:79-95)."""

    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,)
    position: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) shading normal (normalized)
    shader: torch.Tensor  # (N,) i32
    albedo: torch.Tensor  # (N, 3) material.diffuse or base_color
    emission: torch.Tensor  # (N, 3) material.ambient (mesh emitters)
    specular: torch.Tensor  # (N,)
    shininess: torch.Tensor  # (N,)
    ior: torch.Tensor  # (N,) ior1_over_ior2
    extinction: torch.Tensor  # (N, 3)
    uv: torch.Tensor  # (N, 2) plane texture coords
    textured: torch.Tensor  # (N,) bool
    is_mesh: torch.Tensor  # (N,) bool
    converged: torch.Tensor  # (N,) bool — False iff a traversal cap tripped


def _resolve_shader(shader_code: int, uniforms: Uniforms) -> int:
    """Map FROM_SELECTION sentinels to the live uniform values."""
    if shader_code == FROM_SELECTION1:
        return uniforms.selection1
    if shader_code == FROM_SELECTION2:
        return uniforms.selection2
    return shader_code


def _update(best: Hit, closer, **new_fields) -> Hit:
    """``best`` with ``new_fields`` taken on the lanes where ``closer``."""
    out = {}
    for f in fields(Hit):
        cur = getattr(best, f.name)
        new = new_fields.get(f.name)
        if new is None:
            out[f.name] = cur
        elif new.ndim > closer.ndim:
            out[f.name] = vec.where(closer, new, cur)
        else:
            out[f.name] = torch.where(closer, new, cur)
    return Hit(**out)


# Meshes of at most this many triangles fetch their hit rows by a one-hot
# product (``tracer/render/integrator.py:314-336``); light tables of at
# most this many rows likewise (``:563-568``).
ONE_HOT_MAX_TRIANGLES = 128
ONE_HOT_MAX_LIGHTS = 64
# The analytic triangles' test rejects near-parallel rays
# (``tracer/render/integrator.py:218-224``); the mesh's does not.
TRI_EPS_DENOM = 1e-10


def _one_hot(ids, table):
    """``table[ids]`` as the (N, R) x (R, C) product of the ids' one-hot rows
    with the table: exact in float32 with TF32 off, and its backward is a
    product."""
    oh = (ids[:, None] == torch.arange(table.shape[0], device=ids.device)).to(torch.float32)
    return oh @ table


def _material_rows(mats, mat):
    """(N, 11) material rows [diffuse, emission, specular, shininess, ior]
    as a one-hot (N, M) x (M, 11) product."""
    pack = torch.cat([mats.diffuse, mats.emission, mats.specular,
                      mats.shininess[:, None], mats.ior[:, None]], dim=1)
    return _one_hot(mat, pack)


def _small_mesh_table(geom):
    """The (T, 19) rows [v0 v1 v2 n0 n1 n2 mat id] built from the vertices
    and normals, so that gradients reach them through the one-hot product's
    backward; the material-id column is detached."""
    idx = geom.indices.long()
    cols = [geom.vertices[idx[:, c]] for c in range(3)]
    cols += [geom.normals[idx[:, c]] for c in range(3)]
    cols.append(geom.mat_ids.detach().to(torch.float32)[:, None])
    return torch.cat(cols, dim=1)


def _rows(scene: Scene, cfg: SceneConfig) -> tuple:
    """(first row, rows) of the pixel rows this pass renders: the scene's
    band, or the whole frame."""
    return scene.band if scene.band is not None else (0, cfg.height)


def lanes(scene: Scene, cfg: SceneConfig) -> int:
    """Lanes of this pass's wavefront: the band's pixels."""
    return cfg.width * _rows(scene, cfg)[1]


def _frame(scene: Scene, cfg: SceneConfig) -> tuple:
    """The (W, H) the engines tile the wavefront by: the band's rows, which
    start on a tile boundary of the frame (``parallel.shard``), so each ray
    is traced in the same tile as in the whole frame."""
    return cfg.width, _rows(scene, cfg)[1]


def _effective_traversal(scene: Scene, cfg: SceneConfig) -> str:
    """Execution engine for the mesh. BSP-configured scenes run the treelet
    engines (``cfg.bsp_execution == "fast"``): a closest-hit or any-hit
    query does not depend on the traversal."""
    if cfg.traversal == "bsp" and cfg.bsp_execution == "fast" and scene.tb is not None:
        return "bvh"
    return cfg.traversal


@dataclass(frozen=True)
class _Engine:
    """A mesh's traversal engine as the integrator calls it, on detached
    rays under ``no_grad``. ``closest(rays, seed_t)`` returns (triangle id
    or -1, converged) and ``any_hit(rays)`` (blocked, converged), where
    converged is None for an engine without caps, which always converges.
    ``host_free``: a query reads nothing back to the host, so a bounce can
    be captured as a CUDA graph. ``seeded``: the closest hit takes the
    temporal t seed."""

    closest: Callable
    any_hit: Callable
    host_free: bool = False
    seeded: bool = False


def _mesh_engine(scene: Scene, cfg: SceneConfig) -> _Engine:
    """The engine of the scene's mesh: the brute-force engine (``traversal
    == "brute"``), the BSP walk (``"bsp"`` with ``bsp_execution !=
    "fast"``), the ``bvh2`` walk or the ``bvh8`` walk, else the flat engine
    in direct mode and the packet engine in path mode (incoherent bounces
    defeat the flat engine's frustums)."""
    trav = _effective_traversal(scene, cfg)
    geom, frame = scene.geom, _frame(scene, cfg)
    engines = {
        "brute": _Engine(
            lambda r, s: (intersect.mesh_brute_force(r, geom.vertices, geom.indices)[1], None),
            lambda r: (intersect.mesh_brute_force_anyhit(r, geom.vertices, geom.indices), None),
            host_free=True),
        "bsp": _Engine(
            lambda r, s: bsp_mod.bsp_closest_hit(r, scene.bsp, geom.vertices, geom.indices,
                                                 with_conv=True)[1:],
            lambda r: bsp_mod.bsp_any_hit(r, scene.bsp, geom.vertices, geom.indices,
                                          with_conv=True)),
        # The JAX package flags no truncation of this walk.
        "bvh2": _Engine(
            lambda r, s: (traverse.bvh_closest_hit(r, scene.bvh, geom.vertices, geom.indices,
                                                   max_leaf=cfg.max_leaf)[1], None),
            lambda r: (traverse.bvh_any_hit(r, scene.bvh, geom.vertices, geom.indices,
                                            max_leaf=cfg.max_leaf), None)),
        "bvh8": _Engine(
            lambda r, s: wide.closest_hit(r, scene.wide, with_conv=True)[1:],
            lambda r: wide.any_hit(r, scene.wide, with_conv=True)),
        ("bvh", "direct"): _Engine(
            lambda r, s: flat.closest_hit(r, scene.tb, frame=frame, with_conv=True,
                                          seed_t=None if s is None else s.detach())[1:],
            lambda r: flat.any_hit(r, scene.tb, frame=frame, with_conv=True),
            seeded=True),
        ("bvh", "path"): _Engine(
            lambda r, s: packet.closest_hit(r, scene.tb, frame=frame, with_conv=True)[1:],
            lambda r: packet.any_hit(r, scene.tb, frame=frame, with_conv=True)),
    }
    engine = engines.get((trav, cfg.mode) if trav == "bvh" else trav)
    if engine is None:
        raise NotImplementedError(f"traversal {trav!r} is not ported")
    return engine


def trace_closest(scene: Scene, cfg: SceneConfig, rays: Rays,
                  seed_t=None) -> Hit:
    """Closest hit over the analytic spheres, planes and triangles and the
    triangle mesh, as the reference's sequential tmax-shrinking fold
    (``w8e3.wgsl:290-311``). The mesh goes through its engine
    (``_mesh_engine``).

    ``seed_t``: optional per-ray temporal upper-bound hint for the flat
    engine; exact whatever its quality (see
    ``tracer_torch.accel.flat.closest_hit``).
    """
    with obs.span("integrator.trace_closest"):
        n = rays.o.shape[0]
        dev = rays.o.device
        f32 = torch.float32
        z3 = torch.zeros((n, 3), dtype=f32, device=dev)
        yes = torch.ones(n, dtype=torch.bool, device=dev)
        no = torch.zeros(n, dtype=torch.bool, device=dev)
        best = Hit(
            valid=no,
            t=rays.tmax,
            position=z3,
            normal=z3,
            shader=torch.full((n,), 255, dtype=torch.int32, device=dev),
            albedo=z3,
            emission=z3,
            specular=torch.zeros(n, dtype=f32, device=dev),
            shininess=torch.zeros(n, dtype=f32, device=dev),
            ior=torch.full((n,), cfg.sphere_ior_default, dtype=f32, device=dev),
            extinction=z3,
            uv=torch.zeros((n, 2), dtype=f32, device=dev),
            textured=no,
            is_mesh=no,
            converged=yes,
        )

        spheres = scene.spheres
        for i in range(0 if spheres is None else spheres.radius.shape[0]):
            c = spheres.center[i]
            t, ok = intersect.sphere_t(Rays(rays.o, rays.d, rays.tmin, best.t), c,
                                       spheres.radius[i])
            pos = rays.o + t[:, None] * rays.d
            shader = _resolve_shader(spheres.shader_ids[i], scene.uniforms)
            best = _update(
                best, ok,
                valid=yes,
                t=t,
                position=pos,
                normal=vec.normalize(pos - c, eps=1e-24),
                shader=torch.full((n,), shader, dtype=torch.int32, device=dev),
                albedo=spheres.base_color[i].expand(n, 3),
                emission=z3,
                ior=spheres.ior[i].expand(n),
                extinction=spheres.extinction[i].expand(n, 3),
                is_mesh=no,
                textured=no,
            )

        planes = scene.planes
        for i in range(0 if planes is None else planes.normal.shape[0]):
            p0 = planes.position[i]
            nrm0 = planes.normal[i]
            t, ok = intersect.plane_t(Rays(rays.o, rays.d, rays.tmin, best.t), p0, nrm0)
            pos = rays.o + t[:, None] * rays.d
            u = vec.dot(pos - p0, planes.tangent[i])
            v = vec.dot(pos - p0, planes.binormal[i])
            shader = _resolve_shader(planes.shader_ids[i], scene.uniforms)
            best = _update(
                best, ok,
                valid=yes,
                t=t,
                position=pos,
                normal=nrm0.expand(n, 3),
                shader=torch.full((n,), shader, dtype=torch.int32, device=dev),
                albedo=planes.base_color[i].expand(n, 3),
                emission=z3,
                uv=torch.stack([vec.abs(u), vec.abs(v)], dim=-1),
                textured=(planes.textured[i] != 0).expand(n),
                is_mesh=no,
            )

        tris = scene.tris
        for i in range(0 if tris is None else tris.shader.shape[0]):
            v0, v1, v2 = tris.verts[i, 0], tris.verts[i, 1], tris.verts[i, 2]
            t, _, _, ok = intersect.triangle_t(Rays(rays.o, rays.d, rays.tmin, best.t),
                                               v0, v1, v2, eps_denom=TRI_EPS_DENOM)
            shader = _resolve_shader(tris.shader_ids[i], scene.uniforms)
            best = _update(
                best, ok,
                valid=yes,
                t=t,
                position=rays.o + t[:, None] * rays.d,
                normal=vec.normalize(vec.cross(v1 - v0, v2 - v0), eps=1e-24).expand(n, 3),
                shader=torch.full((n,), shader, dtype=torch.int32, device=dev),
                albedo=tris.base_color[i].expand(n, 3),
                emission=z3,
                is_mesh=no,
                textured=no,
            )

        geom = scene.geom
        if geom is None:
            return best
        engine = _mesh_engine(scene, cfg)
        # The traversal carries no gradient: its inputs are detached and it
        # returns integer ids (the accel buffers hold no grads either).
        with torch.no_grad():
            sub = Rays(rays.o.detach(), rays.d.detach(), rays.tmin.detach(),
                       best.t.detach())
            tri, conv = engine.closest(sub, seed_t)
        conv = yes if conv is None else conv
        ok = tri >= 0
        T = geom.indices.shape[0]
        tri_c = tri.long().clamp(0, T - 1)
        if T <= ONE_HOT_MAX_TRIANGLES:
            row = _one_hot(tri_c, _small_mesh_table(geom))
        else:
            row = fetch_tri_rows(geom.vertices, geom.normals, geom.tri_table,
                                 geom.indices, tri_c)
        v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        mat = row[:, 18].detach().long()
        # Re-derivation of t/beta/gamma from the winning id.
        t_d, beta, gamma, _ = intersect.triangle_t(
            Rays(rays.o, rays.d, torch.zeros_like(rays.tmin), rays.tmax),
            v0, v1, v2,
        )
        pos = rays.o + t_d[:, None] * rays.d
        face_n = vec.cross(v1 - v0, v2 - v0)
        if cfg.use_vertex_normals:
            sn = (
                n0 * (1.0 - beta - gamma)[:, None]
                + n1 * beta[:, None]
                + n2 * gamma[:, None]
            )
            # Fall back to the face normal where vertex normals are zero.
            sn = vec.where(vec.dot(sn, sn) > 1e-20, sn, face_n)
        else:
            sn = face_n
        nrm = vec.normalize(sn, eps=1e-24)
        shader = torch.full(
            (n,), _resolve_shader(cfg.mesh_shader, scene.uniforms),
            dtype=torch.int32, device=dev,
        )
        mrow = _material_rows(scene.materials, mat)
        best = _update(
            best, ok,
            valid=yes,
            t=t_d,
            position=pos,
            normal=nrm,
            shader=shader,
            albedo=mrow[:, 0:3],
            emission=mrow[:, 3:6],
            specular=vec.mean3(mrow[:, 6:9]),
            shininess=mrow[:, 9],
            ior=mrow[:, 10],
            is_mesh=yes,
            textured=no,
        )
        return replace(best, converged=best.converged & conv)


def _mesh_only_anyhit(scene: Scene, cfg: SceneConfig, rays: Rays):
    """Trimesh-only occlusion, ``intersect_trimesh_immediate_return`` as the
    holdout shader uses it (``w9e2.wgsl:514-538``): the any-hit query of the
    mesh's engine (``_mesh_engine``); nothing blocks without a mesh.
    Returns (blocked, converged)."""
    if scene.geom is None:
        no = torch.zeros(rays.o.shape[0], dtype=torch.bool, device=rays.o.device)
        return no, ~no
    engine = _mesh_engine(scene, cfg)
    with torch.no_grad():
        srays = Rays(rays.o.detach(), rays.d.detach(), rays.tmin.detach(),
                     rays.tmax.detach())
        blocked, conv = engine.any_hit(srays)
        return blocked, torch.ones_like(blocked) if conv is None else conv


def trace_occluded(scene: Scene, cfg: SceneConfig, rays: Rays):
    """Occlusion over the whole scene (shadow rays): the analytic spheres,
    planes and triangles, then the mesh's any-hit query. The reference's
    shadow test reuses the closest-hit ``intersect_scene``
    (``w8e3.wgsl:469-471``) and reads only whether it hit. Returns
    (blocked, converged)."""
    with obs.span("integrator.trace_occluded"):
        blocked = torch.zeros(rays.o.shape[0], dtype=torch.bool, device=rays.o.device)
        spheres, planes, tris = scene.spheres, scene.planes, scene.tris
        for i in range(0 if spheres is None else spheres.radius.shape[0]):
            _, ok = intersect.sphere_t(rays, spheres.center[i], spheres.radius[i])
            blocked = blocked | ok
        for i in range(0 if planes is None else planes.normal.shape[0]):
            _, ok = intersect.plane_t(rays, planes.position[i], planes.normal[i])
            blocked = blocked | ok
        for i in range(0 if tris is None else tris.shader.shape[0]):
            _, _, _, ok = intersect.triangle_t(rays, tris.verts[i, 0], tris.verts[i, 1],
                                               tris.verts[i, 2], eps_denom=TRI_EPS_DENOM)
            blocked = blocked | ok
        b, conv = _mesh_only_anyhit(scene, cfg, rays)
        return blocked | b, conv


def _sample_point_light_w1(pos, cfg: SceneConfig):
    """``sample_point_light`` (``w1e6.wgsl:239-252``) with the reference's
    quirks: ``w_i`` is the unnormalized offset to the light, and ``l_i``
    divides by ``|d|^4`` (``dist2`` is the squared distance). Returns
    (l_i, w_i, dist2)."""
    lp = vec.const(tuple(cfg.point_light_pos), device=pos.device)
    li = vec.const(tuple(cfg.point_light_intensity), device=pos.device)
    d = lp - pos
    dist2 = vec.dot(d, d)
    return li / (dist2 * dist2)[..., None], d, dist2


def _sample_directional(cfg: SceneConfig, n: int, device):
    """``sample_directional_light`` (w5e2.wgsl:293-304) -> (l_i, w_i, dist)."""
    d = -vec.normalize(vec.const(tuple(cfg.dir_light_direction), device=device))
    li = vec.const(tuple(cfg.dir_light_intensity), device=device)
    return (
        li.expand(n, 3),
        d.expand(n, 3),
        torch.ones(n, dtype=torch.float32, device=device),
    )


def _area_light_attrs(scene: Scene, light_slot):
    """(v0, v1, v2, Le, area, normal) of light triangle ``light_slot`` (an
    index into ``scene.light_indices``), one row per lane, as the JAX
    package selects them: a one-hot product over the (L, 12) light table
    for 0 < L <= ``ONE_HOT_MAX_LIGHTS``, a gather otherwise."""
    tri_all = scene.light_indices.long()
    idx_all = scene.geom.indices[tri_all].long()
    verts = scene.geom.vertices
    slot = light_slot.long()
    v0L, v1L, v2L = (verts[idx_all[:, c]] for c in range(3))
    leL = scene.materials.emission[scene.geom.mat_ids[tri_all].long()]
    if 0 < tri_all.shape[0] <= ONE_HOT_MAX_LIGHTS:
        rows = _one_hot(slot, torch.cat([v0L, v1L, v2L, leL], dim=1))
        v0, v1, v2, l_e = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    else:
        v0, v1, v2, l_e = v0L[slot], v1L[slot], v2L[slot], leL[slot]
    cr = vec.cross(v0 - v1, v0 - v2)
    area = 0.5 * vec.sqrt(vec.dot(cr, cr))
    nrm = vec.normalize(cr, eps=1e-24)
    return v0, v1, v2, l_e, area, nrm


def _sample_area_light_mc(scene: Scene, pos, light_slot, state):
    """``sample_area_light`` with the sqrt barycentric warp
    (``w9e2.wgsl:406-433``): two draws, then a point on the light triangle.
    Returns (l_i, w_i, dist, state')."""
    v0, v1, v2, l_e, area, nrm = _area_light_attrs(scene, light_slot)
    psi1_raw, state = rng.rnd(state)
    psi2, state = rng.rnd(state)
    psi1 = vec.sqrt(psi1_raw)
    alpha = 1.0 - psi1
    beta = (1.0 - psi2) * psi1
    gamma = psi2 * psi1
    p = v0 * alpha[..., None] + v1 * beta[..., None] + v2 * gamma[..., None]
    d = p - pos
    dist = vec.sqrt(vec.dot(d, d))
    w_i = vec.normalize(d, eps=1e-24)
    cos_l = torch.clamp_min(vec.dot(-w_i, nrm), 0.0)
    l_i = l_e * (area * cos_l / (dist * dist))[..., None]
    return l_i, w_i, dist, state


def _sample_area_light_center(scene: Scene, pos, light_slot):
    """The deterministic variant of ``w5e5.wgsl:247-268``: the light
    triangle's centre, with the light's cosine unclamped. Returns (l_i,
    w_i, dist)."""
    v0, v1, v2, l_e, area, nrm = _area_light_attrs(scene, light_slot)
    d = vec.div(v0 + v1 + v2, 3.0) - pos
    dist = vec.sqrt(vec.dot(d, d))
    w_i = vec.normalize(d, eps=1e-24)
    cos_l = vec.dot(-w_i, nrm)
    l_i = l_e * (area * cos_l / (dist * dist))[..., None]
    return l_i, w_i, dist


def _plane_albedo(scene: Scene, cfg: SceneConfig, hit: Hit):
    """The albedo, textured on textured planes (w3): fract(uv * uv_scale)
    sampled by the ``use_texture`` uniform's sampler; ``TEX_NONE``, or no
    texture bound, keeps the base colour."""
    mode = scene.uniforms.use_texture
    if not (cfg.plane_texture and scene.texture is not None) or mode == tex.TEX_NONE:
        return hit.albedo
    uv = hit.uv * scene.uniforms.uv_scale
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    return vec.where(hit.textured, tex.sample(scene.texture, u, v, mode), hit.albedo)


def _lane_fill(x: float, like):
    """An (N,) float32 tensor of ``x`` on ``like``'s lanes and device."""
    return torch.full(like.shape[:1], x, dtype=torch.float32, device=like.device)


def _shade_lambertian_direct(scene, cfg, rays, hit, albedo):
    """Direct Lambertian of the w1/w2/w5/w6/project family
    (``tracer/render/integrator.py:705-798``): the lights of ``cfg.lights``
    with their shadow rays, then the ambient term. Returns (color,
    converged)."""
    n_lanes = hit.t.shape[0]
    dev = hit.t.device
    nrm = hit.normal
    conv = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    diffuse = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
    blocked_point = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    any_point_light = False
    for kind in cfg.lights:
        if kind in ("point_w1", "directional"):
            any_point_light = True
            if kind == "point_w1":
                l_i, w_i, _ = _sample_point_light_w1(hit.position, cfg)
            else:
                l_i, w_i, _ = _sample_directional(cfg, n_lanes, dev)
            if cfg.shadows:
                sray = Rays(o=hit.position + nrm * cfg.eta, d=w_i,
                            tmin=_lane_fill(cfg.eta, nrm), tmax=_lane_fill(cfg.tmax, nrm))
                b1, c1 = trace_occluded(scene, cfg, sray)
                # The point light's shadow replaces earlier ones; the
                # directional light's adds to them.
                blocked_point = b1 if kind == "point_w1" else blocked_point | b1
                conv = conv & c1
            # light_diffuse_contribution (w1e6.wgsl:274-280): unclamped dot.
            diffuse = diffuse + albedo * (
                vec.dot(nrm, w_i)[..., None] * l_i
                * vec.div(1.0 - hit.specular, PI)[..., None])
        elif kind == "directional_n":
            # The w6e1/project loop over lightIndices with a directional
            # sampler ends in ``break``: one unscaled directional sample
            # and no shadow ray (project.wgsl:286-293).
            l_i, w_i, _ = _sample_directional(cfg, n_lanes, dev)
            diffuse = diffuse + albedo * vec.div(vec.dot(nrm, w_i)[..., None] * l_i, PI)
        elif kind == "area_all":
            # w5e5.wgsl:293-318: every emissive triangle, its centre sample,
            # and a shadow ray from the hit point with no normal offset.
            n_lights = 0 if scene.light_indices is None else int(scene.light_indices.shape[0])
            for slot in range(n_lights):
                l_i, w_i, dist = _sample_area_light_center(
                    scene, hit.position,
                    torch.full((n_lanes,), slot, dtype=torch.int32, device=dev))
                sray = Rays(o=hit.position, d=w_i, tmin=_lane_fill(cfg.eta, nrm),
                            tmax=dist - cfg.eta)
                blocked, c1 = trace_occluded(scene, cfg, sray)
                conv = conv & c1
                contrib = vec.div(albedo * vec.dot(nrm, w_i)[..., None] * l_i, PI)
                diffuse = diffuse + vec.where(~blocked, contrib, 0.0)
        else:
            raise NotImplementedError(f"light kind {kind!r} in direct mode")
    if cfg.ambient in ("mix", "mix_ka"):
        # "mix": the base colour is the ambient term (w2e1.wgsl:316);
        # "mix_ka": the mesh material's Ka (w6e1.wgsl:295-297), carried as
        # hit.emission; analytic hits keep the base colour.
        ambient = vec.where(hit.is_mesh, hit.emission, albedo) if cfg.ambient == "mix_ka" \
            else albedo
        lit = 0.9 * diffuse + 0.1 * ambient
        if cfg.shadows and any_point_light:
            return vec.where(blocked_point, ambient * 0.1, lit), conv
        return lit, conv
    if cfg.ambient == "plain_scaled":
        return diffuse + 0.1 * hit.emission, conv
    # "plain": diffuse + the material's emission as ambient term (w5e5).
    return diffuse + hit.emission, conv


def _shade_phong(scene, cfg, rays, hit):
    """``phong`` (``w2e5.wgsl:374-389``): the Phong lobe lit by the point
    light."""
    w_o = vec.normalize(scene.camera.eye - hit.position, eps=1e-24)
    l_i, w_i, _ = _sample_point_light_w1(hit.position, cfg)
    w_r = vec.normalize(vec.reflect(-w_i, hit.normal), eps=1e-24)
    diffuse = vec.div(vec.saturate(vec.dot(hit.normal, w_i))[..., None] * l_i, PI)
    coeff = vec.div(hit.specular * (hit.shininess + 2.0), 2.0 * PI)
    lobe = coeff * vec.pow(vec.saturate(vec.dot(w_o, w_r)), hit.shininess)
    return lobe[..., None] * diffuse


def _shade_transmit_direct(rays, hit, cfg):
    """``transmit`` of w2e3/w2e5 (``w2e5.wgsl:410-446``): deterministic
    refraction, with the reference's out-normal and ior selection; total
    internal reflection gives the error colour and ends the path. Returns
    (color, new_rays, cont)."""
    w_i = -vec.normalize(rays.d, eps=1e-24)
    nrm = vec.normalize(hit.normal, eps=1e-24)
    cos_i = vec.dot(w_i, nrm)
    outside = cos_i < 0.0
    ior = torch.where(outside, hit.ior, torch.reciprocal(hit.ior))
    out_normal = vec.where(outside, -nrm, nrm)
    cos_t2 = 1.0 - (ior * ior) * (1.0 - cos_i * cos_i)
    tir = cos_t2 < 0.0
    sq = vec.sqrt(torch.clamp_min(cos_t2, 0.0))
    tangent = nrm * cos_i[..., None] - w_i
    w_t = ior[..., None] * tangent - out_normal * sq[..., None]
    new_rays = Rays(o=hit.position + w_t * cfg.eta, d=w_t,
                    tmin=_lane_fill(cfg.eta, w_t), tmax=_lane_fill(cfg.tmax, w_t))
    err = vec.const(ERROR_COLOR, device=w_t.device)
    return vec.where(tir, err.expand(w_t.shape), 0.0), new_rays, ~tir


def _shade_lambertian_path(scene, cfg, rays, hit, factor, emit, state):
    """w7e3/w8e3 path-traced Lambertian (``w8e3.wgsl:455-509``): one-sample
    next-event estimation over the emissive triangles (``area_mc``), or
    against the sun (``directional``, ``w9e3.wgsl:451-477``), with a shadow
    ray, emission gating, then a cosine-hemisphere continuation under
    Russian roulette. The draws come in the JAX package's order: the light
    slot and the two barycentric draws (the sun draws none), the roulette
    draw, the warp's two. The area light's estimate (the sample, the shadow
    ray and the contribution) runs under the span ``integrator.nee``.
    Returns (color, new_rays, cont, factor', emit', state', converged)."""
    n_lanes = hit.t.shape[0]
    dev = hit.t.device
    brdf = vec.div(_plane_albedo(scene, cfg, hit), PI)
    nrm = hit.normal
    conv = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    diffuse = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
    L = 0 if scene.light_indices is None else int(scene.light_indices.shape[0])
    if "area_mc" in cfg.lights and L > 0:
        with obs.span("integrator.nee"):
            ri, state = rng.rnd_int(state)
            l_i, w_i, dist, state = _sample_area_light_mc(scene, hit.position, ri % L, state)
            sray = Rays(
                o=hit.position,
                d=w_i,
                tmin=torch.full((n_lanes,), cfg.eta, dtype=torch.float32, device=dev),
                tmax=dist - cfg.eta,
            )
            blocked, c1 = trace_occluded(scene, cfg, sray)
            conv = conv & c1
            contrib = brdf * vec.saturate(vec.dot(nrm, w_i))[..., None] * l_i * float(L)
            if cfg.diffuse_factor:
                contrib = contrib * factor
            diffuse = vec.where(~blocked, contrib, 0.0)
    elif "directional" in cfg.lights:
        # The sun: a shadow ray from the hit point, with no normal offset, to
        # just short of 999999 (w9e3.wgsl:451-477).
        l_i, w_i, _ = _sample_directional(cfg, n_lanes, dev)
        sray = Rays(
            o=hit.position,
            d=w_i,
            tmin=torch.full((n_lanes,), cfg.eta, dtype=torch.float32, device=dev),
            tmax=torch.full((n_lanes,), 999999.0 - cfg.eta, dtype=torch.float32, device=dev),
        )
        blocked, c1 = trace_occluded(scene, cfg, sray)
        conv = conv & c1
        contrib = brdf * vec.saturate(vec.dot(nrm, w_i))[..., None] * l_i
        if cfg.diffuse_factor:
            contrib = contrib * factor
        diffuse = vec.where(~blocked, contrib, 0.0)
    ambient = vec.where(emit, hit.emission, 0.0) if cfg.emit_gating else hit.emission
    if cfg.emission_factor:
        ambient = ambient * factor
    if not cfg.rr:
        # w8e1-style terminal Lambertian: no indirect bounce.
        cont = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
        return diffuse + ambient, rays, cont, factor, emit, state, conv

    factor_new = factor * brdf * PI
    prob = vec.mean3(brdf)
    step, state = rng.rnd(state)
    cont = step < prob
    ind_dir, state_ind = sampling.cosine_hemisphere(nrm, state)
    state = torch.where(cont, state_ind, state)
    factor_new = vec.where(cont, factor_new / torch.clamp_min(prob, 1e-12)[..., None],
                           factor_new)
    new_rays = Rays(
        o=hit.position,
        d=ind_dir,
        tmin=torch.full((n_lanes,), cfg.eta, dtype=torch.float32, device=dev),
        tmax=torch.full((n_lanes,), cfg.tmax, dtype=torch.float32, device=dev),
    )
    emit_new = torch.where(cont, False, emit)
    return diffuse + ambient, new_rays, cont, factor_new, emit_new, state, conv


def _reflect_continue(rays: Rays, hit: Hit, cfg: SceneConfig) -> Rays:
    """``mirror`` (``w8e3.wgsl:512-525``): the reflected continuation ray,
    offset by normal * ETA."""
    nrm = hit.normal
    d = vec.reflect(rays.d, nrm)
    n_lanes, dev = d.shape[0], d.device
    return Rays(
        o=hit.position + nrm * cfg.eta,
        d=d,
        tmin=torch.full((n_lanes,), cfg.eta, dtype=torch.float32, device=dev),
        tmax=torch.full((n_lanes,), cfg.tmax, dtype=torch.float32, device=dev),
    )


def _fresnel_r(cos_i, cos_t, ni_over_nt):
    """``fresnel_r`` (``w9e2.wgsl:193-203``)."""
    ii = ni_over_nt * cos_i
    tt = cos_t
    ti = cos_i
    it = ni_over_nt * cos_t
    r1 = (ii - tt) / (ii + tt)
    r2 = (ti - it) / (ti + it)
    return 0.5 * (r1 * r1 + r2 * r2)


def _shade_transparent_path(scene, cfg, rays, hit, factor, state):
    """Path-mode dielectric (``w8e3.wgsl:527-617``): one draw picks Fresnel
    reflection, refraction or (``dielectric == "absorb"``, on exit only)
    absorption, which ends the path. ``"simple"`` and ``"fresnel"`` absorb
    nothing. Runs under the span ``integrator.dielectric``. Returns (color,
    new_rays, cont, factor', emit', state')."""
    with obs.span("integrator.dielectric"):
        n_lanes = hit.t.shape[0]
        dev = hit.t.device
        ones3 = torch.ones((n_lanes, 3), dtype=torch.float32, device=dev)
        w_i = -vec.normalize(rays.d, eps=1e-24)
        nrm = vec.normalize(hit.normal, eps=1e-24)
        cos_raw = vec.dot(w_i, nrm)
        entering = cos_raw < 0.0
        cos_i = vec.abs(cos_raw)
        ior = torch.where(entering, hit.ior, torch.reciprocal(hit.ior))
        out_normal = vec.where(entering, -nrm, nrm)

        # Beer-Lambert transmittance on exit.
        s = vec.div(vec.length(hit.position - rays.o), cfg.beer_distance_scale)
        t_r_exit = vec.exp(-hit.extinction * s[..., None])
        t_r = vec.where(entering, ones3, t_r_exit) if cfg.dielectric == "absorb" else ones3
        transmission_prob = torch.where(entering, 1.0, vec.mean3(t_r))
        if cfg.dielectric == "fresnel":
            transmission_prob = torch.ones(n_lanes, dtype=torch.float32, device=dev)

        cos_t2 = 1.0 - (ior * ior) * (1.0 - cos_i * cos_i)
        tir = cos_t2 < 0.0
        sq = vec.sqrt(torch.clamp_min(cos_t2, 0.0))
        refl_prob = torch.where(tir, 1.0, _fresnel_r(cos_i, sq, ior))

        tangent = out_normal * cos_i[..., None] - w_i
        w_t = ior[..., None] * tangent - out_normal * sq[..., None]
        # Faithful quirk: the reference calls mirror() after *r was already
        # replaced by the refraction ray (w8e3.wgsl:560-566), so the
        # "reflection" reflects w_t about out_normal, not the incident direction.
        refl_o = hit.position + out_normal * cfg.eta
        refl_d = vec.reflect(w_t, out_normal)

        step, state = rng.rnd(state)
        take_reflect = step < refl_prob
        take_transmit = ~take_reflect & (step < refl_prob + transmission_prob)
        # Neither: absorbed, the path ends (the hit stays recorded).
        new_rays = Rays(
            o=vec.where(take_reflect, refl_o, hit.position),
            d=vec.where(take_reflect, refl_d, w_t),
            tmin=torch.full((n_lanes,), cfg.eta, dtype=torch.float32, device=dev),
            tmax=torch.full((n_lanes,), cfg.tmax, dtype=torch.float32, device=dev),
        )
        cont = take_reflect | take_transmit
        # On transmission out of the medium the throughput picks up
        # T_r / (refl + trans).
        denom = torch.clamp_min(refl_prob + transmission_prob, 1e-8)
        factor_new = vec.where(take_transmit & ~entering, factor * t_r / denom[..., None], factor)
        color = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
        emit_new = torch.ones(n_lanes, dtype=torch.bool, device=dev)
        return color, new_rays, cont, factor_new, emit_new, state


def _shade_holdout(scene, cfg, rays, hit, factor, state):
    """``holdout_shader`` (``w9e2.wgsl:514-538``): an ambient-occlusion
    probe against the mesh; unoccluded lanes see the environment. Returns
    (color, state', converged)."""
    n_lanes = hit.t.shape[0]
    dev = hit.t.device
    nrm = vec.normalize(hit.normal, eps=1e-24)
    ao_dir, state = sampling.cosine_hemisphere(nrm, state)
    aoray = Rays(
        o=hit.position,
        d=ao_dir,
        tmin=torch.full((n_lanes,), cfg.eta, dtype=torch.float32, device=dev),
        tmax=torch.full((n_lanes,), cfg.tmax, dtype=torch.float32, device=dev),
    )
    blocked, conv = _mesh_only_anyhit(scene, cfg, aoray)
    if scene.env is not None:
        env = tex.environment_map(scene.env, vec.normalize(rays.d, eps=1e-24))
    else:
        env = vec.const(tuple(cfg.bg_color), device=dev).expand(n_lanes, 3)
    color = vec.where(blocked, 0.0, env * factor)
    return color, state, conv


def shade(scene, cfg, rays, hit, factor, emit, state):
    """Material dispatch, the WGSL ``shade`` switch (``w9e2.wgsl:436-466``),
    as masked branch blending in the JAX package's order
    (``tracer/render/integrator.py:1044-1158``). Only the ids of
    ``cfg.possible_shaders`` get an arm (each reference scene compiles only
    its own switch arms); any other id gets the error colour. Two arms mean
    different things in the two modes: the mirror keeps ``emit`` in direct
    mode and sets it in path mode, and the transparent shader (7) is the
    deterministic transmit in direct mode and the stochastic dielectric in
    path mode. ``state`` may be None where no arm draws (direct mode
    without the holdout). Returns (color, new_rays, cont, factor', emit',
    state', converged)."""
    with obs.span("integrator.shade"):
        n_lanes = hit.t.shape[0]
        dev = hit.t.device
        path = cfg.mode == "path"
        possible = set(cfg.possible_shaders)
        sid = hit.shader
        yes = torch.ones(n_lanes, dtype=torch.bool, device=dev)
        out = dict(
            color=vec.const(ERROR_COLOR, device=dev).expand(n_lanes, 3),
            rays=rays, cont=~yes, factor=factor, emit=emit, state=state, conv=yes,
        )

        def merge(mask, c, nr=None, ct=None, f=None, e=None, s=None, cv=None):
            """The lanes of ``mask`` take this arm's results. A result that is
            None, or the input passed through, is not merged: the masks are
            disjoint, so those lanes still hold the input."""
            out["color"] = vec.where(mask, c, out["color"])
            if nr is not None and nr is not rays:
                r = out["rays"]
                out["rays"] = Rays(
                    o=vec.where(mask, nr.o, r.o),
                    d=vec.where(mask, nr.d, r.d),
                    tmin=torch.where(mask, nr.tmin, r.tmin),
                    tmax=torch.where(mask, nr.tmax, r.tmax),
                )
            if ct is not None:
                out["cont"] = torch.where(mask, ct, out["cont"])
            if f is not None and f is not factor:
                out["factor"] = vec.where(mask, f, out["factor"])
            if e is not None and e is not emit:
                out["emit"] = torch.where(mask, e, out["emit"])
            if s is not None and s is not state:
                out["state"] = torch.where(mask, s, out["state"])
            if cv is not None:
                out["conv"] = out["conv"] & (~mask | cv)

        albedo = _plane_albedo(scene, cfg, hit)
        if SHADER_LAMBERTIAN in possible:
            m = sid == SHADER_LAMBERTIAN
            if path:
                merge(m, *_shade_lambertian_path(scene, cfg, rays, hit, factor, emit, state))
            else:
                c, cv = _shade_lambertian_direct(scene, cfg, rays, hit, albedo)
                merge(m, c, cv=cv)
        if SHADER_PHONG in possible:
            merge(sid == SHADER_PHONG, _shade_phong(scene, cfg, rays, hit))
        if SHADER_MIRROR in possible:
            z3 = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
            merge(sid == SHADER_MIRROR, z3, _reflect_continue(rays, hit, cfg), yes,
                  e=yes if path else None)
        transparent_direct = SHADER_TRANSPARENT in possible and not path
        if possible & {SHADER_TRANSMIT, SHADER_GLOSSY} or transparent_direct:
            tc, tnr, tct = _shade_transmit_direct(rays, hit, cfg)
            if SHADER_TRANSMIT in possible:
                merge(sid == SHADER_TRANSMIT, tc, tnr, tct)
            if SHADER_GLOSSY in possible:
                merge(sid == SHADER_GLOSSY, _shade_phong(scene, cfg, rays, hit) + tc, tnr, tct)
            if transparent_direct:
                merge(sid == SHADER_TRANSPARENT, tc, tnr, tct)
        if SHADER_NORMAL in possible:
            merge(sid == SHADER_NORMAL, (hit.normal + 1.0) * 0.5)
        if SHADER_BASECOLOR in possible:
            merge(sid == SHADER_BASECOLOR, albedo + hit.emission)
        if SHADER_TRANSPARENT in possible and path:
            merge(sid == SHADER_TRANSPARENT,
                  *_shade_transparent_path(scene, cfg, rays, hit, factor, state))
        if SHADER_HOLDOUT in possible:
            c, s, cv = _shade_holdout(scene, cfg, rays, hit, factor, state)
            merge(sid == SHADER_HOLDOUT, c, s=s, cv=cv)
        return (out["color"], out["rays"], out["cont"], out["factor"], out["emit"],
                out["state"], out["conv"])


# Shader ids that can respawn a continuation ray.
_CONTINUATION_SHADERS = frozenset(
    {SHADER_MIRROR, SHADER_TRANSMIT, SHADER_GLOSSY, SHADER_TRANSPARENT}
)


def _single_bounce(cfg: SceneConfig) -> bool:
    return cfg.mode == "direct" and not (
        _CONTINUATION_SHADERS & set(cfg.possible_shaders)
    )


def bounce_loop(scene: Scene, cfg: SceneConfig, rays0: Rays, state0=None,
                seed_t=None, full_depth: bool = False):
    """The fragment-shader main loop (w8e3.wgsl:264-275) over the wavefront.
    Returns (radiance (N, 3), next seed (N,)).

    Single-bounce scenes take one bounce, and the seed is the mesh hit
    distance (0 where the lane missed). The others run the ``while`` or
    ``scan`` loop (``_loop``) from the per-lane random streams ``state0``,
    and the seed is zeros.
    """
    if not (_single_bounce(cfg) and cfg.max_depth >= 1):
        if cfg.loop not in ("while", "scan"):
            raise NotImplementedError(f"the {cfg.loop!r} bounce loop is not ported")
        radiance = _loop(scene, cfg, rays0, state0, full_depth)
        return radiance, torch.zeros_like(radiance[:, 0])
    obs.count("integrator.bounces")
    with obs.span("integrator.bounce"):
        n = rays0.o.shape[0]
        dev = rays0.o.device
        hit = trace_closest(scene, cfg, rays0, seed_t=seed_t)
        bad = ~hit.converged
        miss = ~hit.valid
        if cfg.env_light and scene.env is not None:
            # The loop's miss colour at throughput one (_bounce).
            bg = tex.environment_map(scene.env, vec.normalize(rays0.d, eps=1e-24))
        else:
            bg = vec.const(tuple(cfg.bg_color), device=dev).expand(n, 3)
        result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        result = result + vec.where(miss, bg, 0.0)
        live = hit.valid
        # The loop's initial throughput and emit flag, as views.
        factor = torch.ones(3, dtype=torch.float32, device=dev).expand(n, 3)
        emit = torch.ones(1, dtype=torch.bool, device=dev).expand(n)
        color, *_, shade_conv = shade(scene, cfg, rays0, hit, factor, emit, state0)
        bad = bad | (live & ~shade_conv)
        if cfg.firefly_clamp > 0.0:
            color = torch.clamp_max(color, cfg.firefly_clamp)
        result = result + vec.where(live, color, 0.0)
        seed_next = torch.where(hit.valid & hit.is_mesh, hit.t, 0.0)
        return _paint_bad(result, bad), seed_next


def _bounce(scene: Scene, cfg: SceneConfig, carry: tuple) -> tuple:
    """One bounce of the wavefront, in either mode (the body of the JAX
    package's loops, ``tracer/render/integrator.py:1201-1253``). ``carry``
    is (ray origin, direction, tmin, tmax, result, factor, emit, done, bad,
    random state), all tensors, the random state an explicit int64 tensor,
    so a recomputed bounce draws the same numbers."""
    o, d, tmin, tmax, result, factor, emit, done, bad, state = carry
    n, dev = o.shape[0], o.device
    # Done lanes collapse their interval to empty, so the engines'
    # alive-culling skips them.
    rays = Rays(o, d, tmin, torch.where(done, tmin, tmax))
    hit = trace_closest(scene, cfg, rays)
    bad = bad | (~done & ~hit.converged)
    miss = ~hit.valid & ~done
    if cfg.env_light and scene.env is not None:
        bg = tex.environment_map(scene.env, vec.normalize(rays.d, eps=1e-24)) * factor
    else:
        bg = vec.const(tuple(cfg.bg_color), device=dev).expand(n, 3)
    result = result + vec.where(miss, bg, 0.0)
    live = hit.valid & ~done
    color, new_rays, cont, factor2, emit2, state2, shade_conv = shade(
        scene, cfg, rays, hit, factor, emit, state)
    bad = bad | (live & ~shade_conv)
    if cfg.firefly_clamp > 0.0:
        color = torch.clamp_max(color, cfg.firefly_clamp)
    result = result + vec.where(live, color, 0.0)
    return (
        vec.where(live, new_rays.o, rays.o),
        vec.where(live, new_rays.d, rays.d),
        torch.where(live, new_rays.tmin, rays.tmin),
        torch.where(live, new_rays.tmax, rays.tmax),
        result,
        vec.where(live, factor2, factor),
        torch.where(live, emit2, emit),
        done | miss | (live & ~cont),
        bad,
        torch.where(live, state2, state),
    )


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy (``jax.checkpoint_policies.checkpoint_dots``):
    keep the outputs of matrix products, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: SceneConfig, body):
    """``body`` under the ``cfg.remat`` policy of the ``scan`` loop
    (``tracer/render/integrator.py:1279-1293``): ``"none"`` keeps every
    residual, ``"full"`` recomputes the bounce in the backward, ``"dots"``
    recomputes all but the matrix products' outputs."""
    if cfg.loop != "scan" or cfg.remat == "none":
        return body
    if cfg.remat not in ("full", "dots"):
        raise NotImplementedError(f"remat {cfg.remat!r} is not ported")
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(_save_products)
    return lambda *carry: checkpoint(body, *carry, use_reentrant=False,
                                     preserve_rng_state=False, **kw)


def _loop(scene: Scene, cfg: SceneConfig, rays0: Rays, state0,
          full_depth: bool = False):
    """Up to ``max_depth`` bounces, stopping as soon as every lane is done
    (one host read of the done mask per bounce); ``full_depth`` runs all
    ``max_depth`` bounces, as the JAX package's ``scan`` does, which gives
    the same radiance and gradients bit for bit."""
    n = rays0.o.shape[0]
    dev = rays0.o.device
    body = _remat(cfg, lambda *carry: _bounce(scene, cfg, carry))
    carry = (
        rays0.o, rays0.d, rays0.tmin, rays0.tmax,
        torch.zeros((n, 3), dtype=torch.float32, device=dev),  # result
        torch.ones((n, 3), dtype=torch.float32, device=dev),  # factor
        torch.ones(n, dtype=torch.bool, device=dev),  # emit (hit_record_init)
        torch.zeros(n, dtype=torch.bool, device=dev),  # done
        torch.zeros(n, dtype=torch.bool, device=dev),  # bad: traversal truncated
        state0,
    )
    graph = _bounce_graph(scene, cfg, carry) if _graphable(scene, cfg, carry) else None
    for _ in range(cfg.max_depth):
        if not full_depth and not obs.host_read("integrator.done", (~carry[7]).any()):
            break
        obs.count("integrator.bounces")
        with obs.span("integrator.bounce"):
            carry = graph.replay(carry) if graph is not None else body(*carry)
    return _paint_bad(carry[4], carry[8])


def _graphable(scene: Scene, cfg: SceneConfig, carry: tuple) -> bool:
    """Whether ``_loop`` replays its bounce from a CUDA graph: a path-mode
    wavefront on the card whose mesh's engine reads nothing back to the
    host inside a query (``host_free``: the brute-force engine), with
    autograd off, and with spans off, so that a traced frame still opens
    every span inside the bounce (it then runs eagerly, bit for bit as the
    graph)."""
    return (carry[0].is_cuda and not obs.SPANS and not torch.is_grad_enabled()
            and cfg.mode == "path" and scene.geom is not None
            and _mesh_engine(scene, cfg).host_free)


def _closure(scene: Scene, cfg: SceneConfig, carry: tuple) -> tuple:
    """What a captured bounce reads besides the carry's contents: the
    configuration, the carry's shapes, and every part of the scene but the
    camera and the frame counter (neither enters a bounce)."""
    u = scene.uniforms
    parts = [getattr(scene, f.name) for f in fields(scene) if f.name not in ("camera", "uniforms")]
    return (cfg, tuple((x.shape, x.dtype, x.device) for x in carry),
            (u.selection1, u.selection2, u.use_texture, u.uv_scale), *parts)


def _same(a, b) -> bool:
    """Tensors and buffers by identity, plain values by equality."""
    if a is b:
        return True
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    plain = (int, float, str, torch.Size, torch.dtype, torch.device, SceneConfig)
    return isinstance(a, plain) and type(a) is type(b) and a == b


class _BounceGraph:
    """``_bounce`` captured as a CUDA graph on fixed carry buffers. A replay
    copies the carry in and launches the eager bounce's kernels, in the same
    order on the same addresses, so the frame is the same bit for bit, with
    one host launch where the eager bounce makes several hundred. The
    counters the bounce adds to (``brute.pairs``) get what the capture
    added, once a replay. The graph holds the scene's buffers that it reads
    (``closure``), so their addresses stay valid while it lives."""

    def __init__(self, scene: Scene, cfg: SceneConfig, carry: tuple):
        dev = carry[0].device
        self.closure = _closure(scene, cfg, carry)
        self.inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in carry)
        for b, x in zip(self.inputs, carry):
            b.copy_(x)
        # One eager bounce on a side stream first, as ``torch.cuda.graph``
        # asks (lazy initialisation stays out of the graph), then the
        # capture, which runs nothing on the card; neither is a bounce of
        # the frame, so what they add to the counters is taken back.
        c0 = obs.counters()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            _bounce(scene, cfg, self.inputs)
        torch.cuda.current_stream(dev).wait_stream(stream)
        c1 = obs.counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(self.graph, stream=stream,
                                                      capture_error_mode="thread_local"):
            self.outputs = _bounce(scene, cfg, self.inputs)
        self.added = {k: n - c0.get(k, 0) for k, n in c1.items() if n != c0.get(k, 0)}
        for k, n in self.added.items():
            obs.count(k, -2 * n)
        obs.count("integrator.bounce_graph_captures")

    def replay(self, carry: tuple) -> tuple:
        for b, x in zip(self.inputs, carry):
            b.copy_(x)
        self.graph.replay()
        obs.count("integrator.bounce_graph_replays")
        for k, n in self.added.items():
            obs.count(k, n)
        return self.outputs


_GRAPH: list = []  # the last captured bounce: one at a time


def _bounce_graph(scene: Scene, cfg: SceneConfig, carry: tuple) -> _BounceGraph:
    """The captured bounce of this scene, configuration and carry shape: the
    one kept if it matches, else a new capture, which replaces it."""
    key = _closure(scene, cfg, carry)
    if _GRAPH and _same(_GRAPH[0].closure, key):
        return _GRAPH[0]
    _GRAPH.clear()
    _GRAPH.append(_BounceGraph(scene, cfg, carry))
    return _GRAPH[0]


def _paint_bad(result, bad):
    """Truncated-traversal lanes render the magenta error sentinel: a
    clipped image is visibly wrong, never silently plausible."""
    err = vec.const(ERROR_COLOR, device=result.device)
    return vec.where(bad, err.expand(result.shape), result)


def _band_uv(scene: Scene, cfg: SceneConfig):
    """The quad coords of the band's pixels, as the whole frame has them."""
    row0, rows = _rows(scene, cfg)
    u, v = pixel_uv(cfg.width, cfg.height, device=scene.device)
    lo, hi = row0 * cfg.width, (row0 + rows) * cfg.width
    return u[lo:hi], v[lo:hi]


def primary_rays(scene: Scene, cfg: SceneConfig, jitter=None) -> Rays:
    """Direct-mode primary rays through the pixel centres offset by
    ``jitter`` ((2,), one stratified sub-sample; None is zero jitter)."""
    dev = scene.device
    u, v = _band_uv(scene, cfg)
    n = lanes(scene, cfg)
    if jitter is None:
        jitter = torch.zeros(2, dtype=torch.float32, device=dev)
    rays = camera_rays(scene.camera, u, v, jitter.expand(n, 2))
    return Rays(
        rays.o, rays.d,
        torch.full((n,), cfg.eta, dtype=torch.float32, device=dev),
        torch.full((n,), cfg.tmax, dtype=torch.float32, device=dev),
    )


def _path_primary(scene: Scene, cfg: SceneConfig):
    """Path-mode primary rays and random streams: each pixel's stream is
    seeded by (launch index, iteration) and its first two draws jitter the
    pixel by up to 1/height (``w8e3.wgsl:254-259``)."""
    dev = scene.device
    u, v = _band_uv(scene, cfg)
    n = lanes(scene, cfg)
    state = _pixel_states(scene, cfg)
    j1, state = rng.rnd(state)
    j2, state = rng.rnd(state)
    jitter = vec.div(torch.stack([j1, j2], dim=-1), float(cfg.height))
    rays = camera_rays(scene.camera, u, v, jitter)
    return Rays(
        rays.o, rays.d,
        torch.full((n,), cfg.eta, dtype=torch.float32, device=dev),
        torch.full((n,), cfg.tmax, dtype=torch.float32, device=dev),
    ), state


def _pixel_states(scene: Scene, cfg: SceneConfig):
    """Each pixel's random stream, seeded by (launch index, iteration)."""
    row0, rows = _rows(scene, cfg)
    first = row0 * cfg.width
    return rng.pixel_seed(torch.arange(first, first + rows * cfg.width, dtype=torch.int64,
                                       device=scene.device), scene.uniforms.iteration)


def _direct_states(scene: Scene, cfg: SceneConfig):
    """Direct mode's random streams: its arms draw nothing, but the holdout
    does, and the bounce loop carries them as the JAX package's does. A
    single bounce without the holdout reads none (the JAX package's
    compiler drops them there)."""
    if _single_bounce(cfg) and SHADER_HOLDOUT not in cfg.possible_shaders:
        return None
    return _pixel_states(scene, cfg)


def _jitters(scene: Scene):
    """Direct mode's stratified sub-pixel offsets, (k, 2)."""
    if scene.jitters is None:
        return torch.zeros((1, 2), dtype=torch.float32, device=scene.device)
    return scene.jitters


def _sample(scene: Scene, cfg: SceneConfig, seed_t, seeding: bool, full_depth: bool):
    """One sample pass over the W x H wavefront, or over the rows of the
    scene's band. Returns (radiance, seed). Direct mode averages the
    stratified sub-samples of ``scene.jitters`` (``w3e3.wgsl:150-165``):
    their sum in order, divided by their count. With ``seeding``, a single
    bounce on an engine that takes the seed starts from ``seed_t`` and each
    sub-sample from the one before it; elsewhere ``seed_t`` passes
    through."""
    if cfg.mode == "path":
        rays, state = _path_primary(scene, cfg)
        return bounce_loop(scene, cfg, rays, state, full_depth=full_depth)[0], seed_t
    seeding = seeding and _single_bounce(cfg) and scene.tb is not None \
        and _mesh_engine(scene, cfg).seeded
    jitters = _jitters(scene)
    state = _direct_states(scene, cfg)
    acc = torch.zeros((lanes(scene, cfg), 3), dtype=torch.float32, device=scene.device)
    for i in range(jitters.shape[0]):
        res, seed = bounce_loop(scene, cfg, primary_rays(scene, cfg, jitters[i]), state,
                                seed_t=seed_t if seeding else None)
        if seeding:
            seed_t = seed
        acc = acc + res
    return vec.div(acc, float(jitters.shape[0])), seed_t


def render_sample(scene: Scene, cfg: SceneConfig, full_depth: bool = False):
    """One sample pass over the W x H wavefront, or over the rows of the
    scene's band (no temporal seed; see ``_sample``). ``full_depth``: path
    mode runs all ``max_depth`` bounces (see ``_loop``)."""
    return _sample(scene, cfg, None, False, full_depth)[0]


def render_sample_seeded(scene: Scene, cfg: SceneConfig, seed_t):
    """``render_sample`` with temporal t-bound seeding: the flat engine's
    per-sub-tile break bounds start at last frame's depths, each sub-sample
    from the one before it. Returns (radiance, next_seed); the radiance
    equals the unseeded render's, since lanes whose hint undershoots are
    re-traced by the repair pass. Scenes of more than one bounce, and
    meshes off the flat engine, are not seeded: their seed passes
    through."""
    return _sample(scene, cfg, seed_t, True, False)


def accumulate(result, accum, iteration: int):
    """Progressive mean: (result + accum * iter) / (iter + 1)
    (w8e3.wgsl:277-278), written into ``accum`` in place."""
    it = float(iteration)
    one = torch.tensor(it + 1.0, dtype=torch.float32, device=accum.device)
    return accum.mul_(it).add_(result).div_(one)


def to_display(accum, cfg: SceneConfig):
    """Display transform: saturate(pow(accum, gamma)) with the reference's
    negative/NaN magenta guard (w8e3.wgsl:280-287)."""
    framed = vec.saturate(torch.pow(torch.clamp_min(accum, 0.0), cfg.gamma))
    bad = (accum < 0.0).any(dim=-1) | torch.isnan(accum).any(dim=-1)
    err = torch.tensor(ERROR_COLOR, dtype=torch.float32, device=accum.device)
    return vec.where(bad, err.expand(framed.shape), framed)


def with_iteration(scene: Scene, iteration: int) -> Scene:
    return replace(scene, uniforms=replace(scene.uniforms, iteration=iteration))

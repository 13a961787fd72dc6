"""Wavefront integrator, direct-mode mesh slice (port of
``tracer.render.integrator``).

The whole W*H pixel wavefront advances together: closest hit against the
triangle mesh through the flat treelet engine, the Lambertian shade under
the ``directional_n`` light with the ``plain_scaled`` ambient term
(project.wgsl), and the background colour on misses. Scenes whose shaders
cannot spawn a continuation ray take exactly one bounce
(``_single_bounce``), which is the only bounce driver of this slice.

Hit attributes are re-derived from the winning triangle id (one row gather
from the per-triangle table, then the Möller test of that one triangle), as
in the JAX package; its one-hot matmul fetches, a TPU workaround, are plain
index gathers here.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from tracer_torch.accel import flat
from tracer_torch.geometry.device import (
    SHADER_GLOSSY,
    SHADER_LAMBERTIAN,
    SHADER_MIRROR,
    SHADER_TRANSMIT,
    SHADER_TRANSPARENT,
)
from tracer_torch.kernels import intersect
from tracer_torch.kernels.intersect import Rays
from tracer_torch.math import vec
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


def trace_closest(scene: Scene, cfg: SceneConfig, rays: Rays,
                  seed_t=None) -> Hit:
    """Closest hit against the scene's triangle mesh (treelet flat engine).

    ``seed_t``: optional per-ray temporal upper-bound hint; exact whatever
    its quality (see ``tracer_torch.accel.flat.closest_hit``).
    """
    n = rays.o.shape[0]
    dev = rays.o.device
    f32 = torch.float32
    z3 = torch.zeros((n, 3), dtype=f32, device=dev)
    best = Hit(
        valid=torch.zeros(n, dtype=torch.bool, device=dev),
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
        textured=torch.zeros(n, dtype=torch.bool, device=dev),
        is_mesh=torch.zeros(n, dtype=torch.bool, device=dev),
        converged=torch.ones(n, dtype=torch.bool, device=dev),
    )

    geom = scene.geom
    _, tri, conv = flat.closest_hit(
        Rays(rays.o, rays.d, rays.tmin, best.t), scene.tb,
        frame=(cfg.width, cfg.height), with_conv=True, seed_t=seed_t,
    )
    ok = tri >= 0
    tri_c = tri.long().clamp(0, geom.indices.shape[0] - 1)
    row = geom.tri_table[tri_c]
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    mat = row[:, 18].long()
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
    mats = scene.materials
    mesh_fields = dict(
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        t=t_d,
        position=pos,
        normal=nrm,
        shader=shader,
        albedo=mats.diffuse[mat],
        emission=mats.emission[mat],
        specular=vec.mean3(mats.specular[mat]),
        shininess=mats.shininess[mat],
        ior=mats.ior[mat],
        is_mesh=torch.ones(n, dtype=torch.bool, device=dev),
        textured=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    out = {}
    for f in fields(Hit):
        cur = getattr(best, f.name)
        new = mesh_fields.get(f.name)
        if new is None:
            out[f.name] = cur
        elif new.ndim > ok.ndim:
            out[f.name] = vec.where(ok, new, cur)
        else:
            out[f.name] = torch.where(ok, new, cur)
    out["converged"] = out["converged"] & conv
    return Hit(**out)


def _sample_directional(cfg: SceneConfig, n: int, device):
    """``sample_directional_light`` (w5e2.wgsl:293-304) -> (l_i, w_i, dist)."""
    d = -vec.normalize(torch.tensor(cfg.dir_light_direction, dtype=torch.float32,
                                    device=device))
    li = torch.tensor(cfg.dir_light_intensity, dtype=torch.float32, device=device)
    return (
        li.expand(n, 3),
        d.expand(n, 3),
        torch.ones(n, dtype=torch.float32, device=device),
    )


def _shade_lambertian_direct(scene, cfg, rays, hit, albedo):
    """Direct Lambertian (project.wgsl:286-295): the ``directional_n`` light
    without a shadow ray and the ``plain_scaled`` ambient term. Returns
    (color, converged)."""
    n_lanes = hit.t.shape[0]
    dev = hit.t.device
    nrm = hit.normal
    conv = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    diffuse = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
    for kind in cfg.lights:
        if kind != "directional_n":
            raise NotImplementedError(f"light kind {kind!r} is not ported")
        # One unscaled directional sample; no shadow ray (project.wgsl:286-293).
        l_i, w_i, _ = _sample_directional(cfg, n_lanes, dev)
        diffuse = diffuse + albedo * vec.div(vec.dot(nrm, w_i)[..., None] * l_i, PI)
    if cfg.ambient != "plain_scaled":
        raise NotImplementedError(f"ambient mode {cfg.ambient!r} is not ported")
    return diffuse + 0.1 * hit.emission, conv


def shade(scene, cfg, rays, hit):
    """Material dispatch (the WGSL ``shade`` switch) for direct mode: the
    Lambertian arm; lanes of any other shader get the error colour.
    Returns (color, converged)."""
    n_lanes = hit.t.shape[0]
    dev = hit.t.device
    color = torch.tensor(ERROR_COLOR, dtype=torch.float32, device=dev).expand(n_lanes, 3)
    conv_out = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    possible = set(cfg.possible_shaders)
    if possible - {SHADER_LAMBERTIAN}:
        raise NotImplementedError(
            f"shaders {sorted(possible - {SHADER_LAMBERTIAN})} are not ported")
    if cfg.mode != "direct":
        raise NotImplementedError(f"mode {cfg.mode!r} is not ported")
    m = hit.shader == SHADER_LAMBERTIAN
    c, cv = _shade_lambertian_direct(scene, cfg, rays, hit, hit.albedo)
    color = vec.where(m, c, color)
    conv_out = conv_out & (~m | cv)
    return color, conv_out


# Shader ids that can respawn a continuation ray.
_CONTINUATION_SHADERS = frozenset(
    {SHADER_MIRROR, SHADER_TRANSMIT, SHADER_GLOSSY, SHADER_TRANSPARENT}
)


def _single_bounce(cfg: SceneConfig) -> bool:
    return cfg.mode == "direct" and not (
        _CONTINUATION_SHADERS & set(cfg.possible_shaders)
    )


def bounce_loop(scene: Scene, cfg: SceneConfig, rays0: Rays, seed_t=None):
    """One bounce of the fragment-shader main loop (w8e3.wgsl:264-275) for
    single-bounce scenes. Returns (radiance (N, 3), next seed (N,)): the
    seed is the mesh hit distance, 0 where the lane missed."""
    if not (_single_bounce(cfg) and cfg.max_depth >= 1):
        raise NotImplementedError("only the single-bounce driver is ported")
    n = rays0.o.shape[0]
    dev = rays0.o.device
    hit = trace_closest(scene, cfg, rays0, seed_t=seed_t)
    bad = ~hit.converged
    miss = ~hit.valid
    bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev).expand(n, 3)
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    result = result + vec.where(miss, bg, 0.0)
    live = hit.valid
    color, shade_conv = shade(scene, cfg, rays0, hit)
    bad = bad | (live & ~shade_conv)
    if cfg.firefly_clamp > 0.0:
        color = torch.clamp_max(color, cfg.firefly_clamp)
    result = result + vec.where(live, color, 0.0)
    seed_next = torch.where(hit.valid & hit.is_mesh, hit.t, 0.0)
    return _paint_bad(result, bad), seed_next


def _paint_bad(result, bad):
    """Truncated-traversal lanes render the magenta error sentinel: a
    clipped image is visibly wrong, never silently plausible."""
    err = torch.tensor(ERROR_COLOR, dtype=torch.float32, device=result.device)
    return vec.where(bad, err.expand(result.shape), result)


def primary_rays(scene: Scene, cfg: SceneConfig) -> Rays:
    w, h = cfg.width, cfg.height
    dev = scene.device
    u, v = pixel_uv(w, h, device=dev)
    n = w * h
    # Direct mode without subdivision: one stratum, zero jitter.
    jitter = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    rays = camera_rays(scene.camera, u, v, jitter)
    return Rays(
        rays.o, rays.d,
        torch.full((n,), cfg.eta, dtype=torch.float32, device=dev),
        torch.full((n,), cfg.tmax, dtype=torch.float32, device=dev),
    )


def render_sample(scene: Scene, cfg: SceneConfig):
    """One sample pass over the full W x H wavefront (no temporal seed)."""
    return bounce_loop(scene, cfg, primary_rays(scene, cfg))[0]


def render_sample_seeded(scene: Scene, cfg: SceneConfig, seed_t):
    """``render_sample`` with temporal t-bound seeding: the flat engine's
    per-sub-tile break bounds start at last frame's depths. Returns
    (radiance, next_seed); the radiance equals the unseeded render's, since
    lanes whose hint undershoots are re-traced by the repair pass."""
    return bounce_loop(scene, cfg, primary_rays(scene, cfg), seed_t=seed_t)


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

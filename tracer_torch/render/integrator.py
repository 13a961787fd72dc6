"""Wavefront integrator (port of ``tracer.render.integrator``): the
direct-mode mesh slice and path mode on a mesh with analytic planes.

The whole W*H pixel wavefront advances together.

* Direct mode: closest hit against the triangle mesh through the flat
  treelet engine, the Lambertian shade under the ``directional_n`` light
  with the ``plain_scaled`` ambient term (project.wgsl), and the background
  colour on misses. Scenes whose shaders cannot spawn a continuation ray
  take exactly one bounce (``_single_bounce``).
* Path mode (``W9 E1``/``W9 E2``): per-pixel random jitter and streams
  (``math.rng``), a multi-bounce ``while`` loop that stops when every lane
  is done, analytic planes, the mesh through the packet engine, the
  environment map (or the background colour) on misses, the path-traced
  Lambertian without lights (emission gating and Russian roulette with
  cosine-hemisphere continuation), and the holdout shader, whose ambient
  occlusion probe is a mesh any-hit query.

The path is differentiable as in the JAX package: the traversal runs on
detached inputs under ``no_grad`` and returns integer ids, and every hit
attribute is re-derived from the winning id (a row fetch, then the Möller
test of that one triangle), so gradients reach the camera, the vertices and
normals (through ``fetch_tri_rows``) and the materials. The material fetch
is a one-hot product, whose backward is a product (deterministic on the
card) where a gather's would be a scatter. TF32 is off
(``tracer_torch/__init__.py``), so that float32 product is an exact
selection on every device. Path-mode gradients are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from tracer_torch.accel import flat, packet
from tracer_torch.geometry.device import (
    SHADER_GLOSSY,
    SHADER_HOLDOUT,
    SHADER_LAMBERTIAN,
    SHADER_MIRROR,
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


def _material_rows(mats, mat):
    """(N, 11) material rows [diffuse, emission, specular, shininess, ior]
    as a one-hot (N, M) x (M, 11) product."""
    M = mats.diffuse.shape[0]
    oh = (mat[:, None] == torch.arange(M, device=mat.device)).to(torch.float32)
    pack = torch.cat([mats.diffuse, mats.emission, mats.specular,
                      mats.shininess[:, None], mats.ior[:, None]], dim=1)
    return oh @ pack


def trace_closest(scene: Scene, cfg: SceneConfig, rays: Rays,
                  seed_t=None) -> Hit:
    """Closest hit over the analytic planes and the triangle mesh, as the
    reference's sequential tmax-shrinking fold (``w8e3.wgsl:290-311``). The
    mesh goes through the flat engine in direct mode and through the packet
    engine in path mode (incoherent bounces defeat the flat engine's
    frustums).

    ``seed_t``: optional per-ray temporal upper-bound hint for the flat
    engine; exact whatever its quality (see
    ``tracer_torch.accel.flat.closest_hit``).
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

    planes = scene.planes
    for i in range(0 if planes is None else planes.normal.shape[0]):
        p0 = planes.position[i]
        nrm0 = planes.normal[i]
        t, ok = intersect.plane_t(Rays(rays.o, rays.d, rays.tmin, best.t), p0, nrm0)
        pos = rays.o + t[:, None] * rays.d
        u = vec.dot(pos - p0, planes.tangent[i])
        v = vec.dot(pos - p0, planes.binormal[i])
        shader = _resolve_shader(int(planes.shader[i]), scene.uniforms)
        best = _update(
            best, ok,
            valid=torch.ones(n, dtype=torch.bool, device=dev),
            t=t,
            position=pos,
            normal=nrm0.expand(n, 3),
            shader=torch.full((n,), shader, dtype=torch.int32, device=dev),
            albedo=planes.base_color[i].expand(n, 3),
            emission=z3,
            uv=torch.stack([torch.abs(u), torch.abs(v)], dim=-1),
            textured=(planes.textured[i] != 0).expand(n),
            is_mesh=torch.zeros(n, dtype=torch.bool, device=dev),
        )

    geom = scene.geom
    # The traversal carries no gradient: its inputs are detached and it
    # returns integer ids (the accel buffers hold no grads either).
    with torch.no_grad():
        sub = Rays(rays.o.detach(), rays.d.detach(), rays.tmin.detach(),
                   best.t.detach())
        if cfg.mode == "direct":
            _, tri, conv = flat.closest_hit(
                sub, scene.tb, frame=(cfg.width, cfg.height), with_conv=True,
                seed_t=None if seed_t is None else seed_t.detach(),
            )
        else:
            _, tri, conv = packet.closest_hit(
                sub, scene.tb, frame=(cfg.width, cfg.height), with_conv=True)
    ok = tri >= 0
    T = geom.indices.shape[0]
    tri_c = tri.long().clamp(0, T - 1)
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
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        t=t_d,
        position=pos,
        normal=nrm,
        shader=shader,
        albedo=mrow[:, 0:3],
        emission=mrow[:, 3:6],
        specular=vec.mean3(mrow[:, 6:9]),
        shininess=mrow[:, 9],
        ior=mrow[:, 10],
        is_mesh=torch.ones(n, dtype=torch.bool, device=dev),
        textured=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    return replace(best, converged=best.converged & conv)


def _mesh_only_anyhit(scene: Scene, cfg: SceneConfig, rays: Rays):
    """Trimesh-only occlusion, ``intersect_trimesh_immediate_return`` as the
    holdout shader uses it (``w9e2.wgsl:514-538``), through the packet
    engine (path mode). Returns (blocked, converged)."""
    with torch.no_grad():
        srays = Rays(rays.o.detach(), rays.d.detach(), rays.tmin.detach(),
                     rays.tmax.detach())
        return packet.any_hit(srays, scene.tb, frame=(cfg.width, cfg.height),
                              with_conv=True)


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


def _shade_lambertian_path(scene, cfg, rays, hit, factor, emit, state):
    """w7e3/w8e3 path-traced Lambertian without lights: emission gating,
    then a cosine-hemisphere continuation under Russian roulette
    (``w8e3.wgsl:475-509``). Next-event estimation (area lights, the sun)
    is not ported. Returns (color, new_rays, cont, factor', emit', state',
    converged)."""
    n_lanes = hit.t.shape[0]
    dev = hit.t.device
    if "area_mc" in cfg.lights or "directional" in cfg.lights:
        raise NotImplementedError(f"next-event estimation ({cfg.lights}) is not ported")
    brdf = vec.div(hit.albedo, PI)
    conv = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    diffuse = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
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
    ind_dir, state_ind = sampling.cosine_hemisphere(hit.normal, state)
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
        env = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev).expand(n_lanes, 3)
    color = vec.where(blocked, 0.0, env * factor)
    return color, state, conv


def shade_path(scene, cfg, rays, hit, factor, emit, state):
    """Material dispatch of path mode (the WGSL ``shade`` switch,
    ``w9e2.wgsl:436-466``) as masked branch blending over the shaders the
    scene can produce: Lambertian and holdout. Lanes of any other shader
    get the error colour. Returns (color, new_rays, cont, factor', emit',
    state', converged)."""
    n_lanes = hit.t.shape[0]
    dev = hit.t.device
    possible = set(cfg.possible_shaders)
    if possible - {SHADER_LAMBERTIAN, SHADER_HOLDOUT}:
        raise NotImplementedError(
            f"shaders {sorted(possible - {SHADER_LAMBERTIAN, SHADER_HOLDOUT})} "
            "are not ported in path mode")
    sid = hit.shader
    no = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    out = dict(
        color=torch.tensor(ERROR_COLOR, dtype=torch.float32, device=dev).expand(n_lanes, 3),
        rays=rays, cont=no, factor=factor, emit=emit, state=state,
        conv=torch.ones(n_lanes, dtype=torch.bool, device=dev),
    )

    def merge(mask, c, nr, ct, f, e, s, cv):
        r = out["rays"]
        out["color"] = vec.where(mask, c, out["color"])
        out["rays"] = Rays(
            o=vec.where(mask, nr.o, r.o),
            d=vec.where(mask, nr.d, r.d),
            tmin=torch.where(mask, nr.tmin, r.tmin),
            tmax=torch.where(mask, nr.tmax, r.tmax),
        )
        out["cont"] = torch.where(mask, ct, out["cont"])
        out["factor"] = vec.where(mask, f, out["factor"])
        out["emit"] = torch.where(mask, e, out["emit"])
        out["state"] = torch.where(mask, s, out["state"])
        out["conv"] = out["conv"] & (~mask | cv)

    if SHADER_LAMBERTIAN in possible:
        m = sid == SHADER_LAMBERTIAN
        merge(m, *_shade_lambertian_path(scene, cfg, rays, hit, factor, emit, state))
    if SHADER_HOLDOUT in possible:
        m = sid == SHADER_HOLDOUT
        c, s, cv = _shade_holdout(scene, cfg, rays, hit, factor, state)
        merge(m, c, rays, no, factor, emit, s, cv)
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
                seed_t=None):
    """The fragment-shader main loop (w8e3.wgsl:264-275) over the wavefront.
    Returns (radiance (N, 3), next seed (N,)).

    Single-bounce scenes take one bounce, and the seed is the mesh hit
    distance (0 where the lane missed). Path mode runs the ``while`` loop
    from the per-lane random streams ``state0``, and the seed is zeros.
    """
    if not (_single_bounce(cfg) and cfg.max_depth >= 1):
        if cfg.mode != "path" or cfg.loop != "while":
            raise NotImplementedError(
                f"the {cfg.loop!r} bounce loop in {cfg.mode!r} mode is not ported")
        radiance = _path_loop(scene, cfg, rays0, state0)
        return radiance, torch.zeros_like(radiance[:, 0])
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


def _path_loop(scene: Scene, cfg: SceneConfig, rays0: Rays, state0):
    """The ``while`` loop: up to ``max_depth`` bounces, stopping as soon
    as every lane is done (one host read of the done mask per bounce)."""
    n = rays0.o.shape[0]
    dev = rays0.o.device
    rays = rays0
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    factor = torch.ones((n, 3), dtype=torch.float32, device=dev)
    emit = torch.ones(n, dtype=torch.bool, device=dev)  # hit_record_init
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)  # traversal truncated
    state = state0
    depth = 0
    while depth < cfg.max_depth and bool((~done).any()):
        # Done lanes collapse their interval to empty, so the engines'
        # alive-culling skips them.
        rays = Rays(rays.o, rays.d, rays.tmin, torch.where(done, rays.tmin, rays.tmax))
        hit = trace_closest(scene, cfg, rays)
        bad = bad | (~done & ~hit.converged)
        miss = ~hit.valid & ~done
        if cfg.env_light and scene.env is not None:
            bg = tex.environment_map(scene.env, vec.normalize(rays.d, eps=1e-24)) * factor
        else:
            bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev).expand(n, 3)
        result = result + vec.where(miss, bg, 0.0)
        live = hit.valid & ~done
        color, new_rays, cont, factor2, emit2, state2, shade_conv = shade_path(
            scene, cfg, rays, hit, factor, emit, state)
        bad = bad | (live & ~shade_conv)
        if cfg.firefly_clamp > 0.0:
            color = torch.clamp_max(color, cfg.firefly_clamp)
        result = result + vec.where(live, color, 0.0)
        rays = Rays(
            o=vec.where(live, new_rays.o, rays.o),
            d=vec.where(live, new_rays.d, rays.d),
            tmin=torch.where(live, new_rays.tmin, rays.tmin),
            tmax=torch.where(live, new_rays.tmax, rays.tmax),
        )
        factor = vec.where(live, factor2, factor)
        emit = torch.where(live, emit2, emit)
        state = torch.where(live, state2, state)
        done = done | miss | (live & ~cont)
        depth += 1
    return _paint_bad(result, bad)


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


def _path_primary(scene: Scene, cfg: SceneConfig):
    """Path-mode primary rays and random streams: each pixel's stream is
    seeded by (launch index, iteration) and its first two draws jitter the
    pixel by up to 1/height (``w8e3.wgsl:254-259``)."""
    w, h = cfg.width, cfg.height
    dev = scene.device
    u, v = pixel_uv(w, h, device=dev)
    n = w * h
    state = rng.pixel_seed(torch.arange(n, dtype=torch.int64, device=dev),
                           scene.uniforms.iteration)
    j1, state = rng.rnd(state)
    j2, state = rng.rnd(state)
    jitter = vec.div(torch.stack([j1, j2], dim=-1), float(h))
    rays = camera_rays(scene.camera, u, v, jitter)
    return Rays(
        rays.o, rays.d,
        torch.full((n,), cfg.eta, dtype=torch.float32, device=dev),
        torch.full((n,), cfg.tmax, dtype=torch.float32, device=dev),
    ), state


def render_sample(scene: Scene, cfg: SceneConfig):
    """One sample pass over the full W x H wavefront (no temporal seed)."""
    if cfg.mode == "path":
        rays, state = _path_primary(scene, cfg)
        return bounce_loop(scene, cfg, rays, state)[0]
    return bounce_loop(scene, cfg, primary_rays(scene, cfg))[0]


def render_sample_seeded(scene: Scene, cfg: SceneConfig, seed_t):
    """``render_sample`` with temporal t-bound seeding: the flat engine's
    per-sub-tile break bounds start at last frame's depths. Returns
    (radiance, next_seed); the radiance equals the unseeded render's, since
    lanes whose hint undershoots are re-traced by the repair pass. Scenes
    of more than one bounce are not seeded: their seed passes through."""
    if not _single_bounce(cfg):
        return render_sample(scene, cfg), seed_t
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

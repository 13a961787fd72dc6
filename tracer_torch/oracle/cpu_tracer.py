"""Independent CPU oracle tracer (scalar NumPy, per-pixel python loop): the
port's own copy of ``tracer.oracle.cpu_tracer``, line for line, with the
jitter table taken from ``tracer_torch.math.sampling``.

This is a *second implementation* of the reference's WGSL algorithms
(the reference renderer's ``res/shaders/w*.wgsl``), deliberately written in the
straight-line scalar style of the shaders rather than the wavefront style of
``tracer_torch.render.integrator`` — it is the golden reference the port's
renderer is held to where no JAX runs (on the card's machine) as well as in
the tests. Slow by design; use small resolutions.

The PRNG is a pure-python reimplementation of the same TEA/MCG31 generator so
the random streams match the device renderer draw-for-draw.
"""

from __future__ import annotations

import numpy as np

F = np.float32

# --- pure-python PRNG (TEA seed + MCG31), bit-identical to tracer.math.rng
MASK32 = 0xFFFFFFFF


def tea_seed(v0: int, v1: int, rounds: int = 16) -> int:
    s0 = 0
    v0 &= MASK32
    v1 &= MASK32
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (
            v0
            + (
                (((v1 << 4) & MASK32) + 0xA341316C)
                ^ ((v1 + s0) & MASK32)
                ^ ((v1 >> 5) + 0xC8013EA4)
            )
        ) & MASK32
        v1 = (
            v1
            + (
                (((v0 << 4) & MASK32) + 0xAD90777D)
                ^ ((v0 + s0) & MASK32)
                ^ ((v0 >> 5) + 0x7E95761E)
            )
        ) & MASK32
    return v0


class Rng:
    def __init__(self, state: int):
        self.state = state & MASK32

    def mcg31(self) -> int:
        self.state = (1977654935 * self.state) & 0x7FFFFFFF
        return self.state

    def rnd(self) -> np.float32:
        return F(self.mcg31()) * F(1.0 / 2147483648.0)

    def rnd_int(self) -> int:
        return self.mcg31()


def v3(x, y=None, z=None):
    if y is None:
        return np.array([x, x, x], F)
    return np.array([x, y, z], F)


def dot(a, b):
    return F(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross(a, b):
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        F,
    )


def normalize(a):
    return (a / np.sqrt(dot(a, a))).astype(F)


def reflect(d, n):
    return (d - 2 * dot(d, n) * n).astype(F)


def saturate(x):
    return np.clip(x, 0.0, 1.0).astype(F)


PIF = F(np.pi)


class Ray:
    __slots__ = ("o", "d", "tmin", "tmax")

    def __init__(self, d, o, tmax=F(5000.0), tmin=F(1e-5)):
        self.o = o.astype(F)
        self.d = d.astype(F)
        self.tmin = F(tmin)
        self.tmax = F(tmax)

    def at(self, t):
        return (self.o + self.d * t).astype(F)


class HitRec:
    def __init__(self):
        self.has_hit = False
        self.dist = F(0)
        self.position = v3(0.0)
        self.normal = v3(0.0)
        self.shader = 255
        self.base_color = v3(0.0)
        self.emission = v3(0.0)
        self.specular = F(0)
        self.shininess = F(0)
        self.ior = F(1.5)
        self.extinction = v3(0.0)
        self.factor = v3(1.0)
        self.emit = True
        self.valid = False
        self.material = -1
        self.is_mesh = False
        self.uv = np.zeros(2, F)  # plane texture coords (w3)
        self.textured = False


class OracleScene:
    """Plain-python scene: lists of analytic prims + optional mesh arrays."""

    def __init__(self):
        self.spheres = []  # (center, radius, shader, base_color, ior, extinction)
        # (position, normal, tangent, binormal, shader, base_color, textured)
        self.planes = []
        self.tris = []  # (v0, v1, v2, shader, base_color)
        self.mesh_vertices = None  # (V,3)
        self.mesh_normals = None
        self.mesh_indices = None  # (T,3)
        self.mesh_matids = None
        self.mat_diffuse = None
        self.mat_emission = None
        self.light_indices = []  # emissive triangle ids
        self.mesh_shader = 0
        self.use_vertex_normals = True
        # Plane texture (w3): (H, W, 4) f32 image + sampler mode + uv scale.
        self.texture_img = None
        self.tex_mode = 0  # TextureUse id (0 = none)
        self.uv_scale = np.ones(2, F)
        # Environment map (w9): lat-long image; kind 2 = RGBE-encoded alpha.
        self.env_img = None
        self.env_rgbe = False


def intersect_sphere(ray: Ray, hit: HitRec, center, radius):
    oc = ray.o - center
    a = dot(ray.d, ray.d)
    b2 = dot(oc, ray.d)
    c = dot(oc, oc) - F(radius) * F(radius)
    disc = b2 * b2 - a * c
    if disc < 0:
        return False
    sq = F(np.sqrt(disc))
    root = (-b2 - sq) / a
    if root < ray.tmin or root > ray.tmax:
        root = (-b2 + sq) / a
        if root < ray.tmin or root > ray.tmax:
            return False
    ray.tmax = F(root)
    hit.dist = F(root)
    hit.position = ray.at(root)
    hit.normal = normalize(hit.position - center)
    return True


def intersect_plane(ray: Ray, hit: HitRec, position, normal):
    t = dot(position - ray.o, normal) / dot(ray.d, normal)
    if t < ray.tmin or t > ray.tmax:
        return False
    ray.tmax = F(t)
    hit.dist = F(t)
    hit.position = ray.at(t)
    hit.normal = normal.astype(F)
    return True


def intersect_triangle(ray: Ray, hit: HitRec, v0, v1, v2, eps=True):
    e0 = v1 - v0
    e1 = v2 - v0
    o_to_v0 = v0 - ray.o
    n = cross(e0, e1)
    nom = cross(o_to_v0, ray.d)
    denom = dot(ray.d, n)
    if eps and abs(denom) < 1e-10:
        return False
    beta = dot(nom, e1) / denom
    gamma = -dot(nom, e0) / denom
    t = dot(o_to_v0, n) / denom
    if beta < 0 or gamma < 0 or beta + gamma > 1 or t > ray.tmax or t < ray.tmin:
        return False
    ray.tmax = F(t)
    hit.dist = F(t)
    hit.position = ray.at(t)
    hit.normal = normalize(n)
    return True


def intersect_scene(scene: OracleScene, ray: Ray, hit: HitRec, cfg) -> bool:
    has = False
    for (c, r, sh, bc, ior, ext) in scene.spheres:
        if intersect_sphere(ray, hit, c, r):
            hit.shader = sh
            hit.base_color = bc
            hit.ior = F(ior)
            hit.extinction = ext
            hit.emission = v3(0.0)
            hit.is_mesh = False
            has = True
    for (p, n, tg, bn, sh, bc, txd) in scene.planes:
        if intersect_plane(ray, hit, p, n):
            hit.shader = sh
            hit.base_color = bc
            hit.emission = v3(0.0)
            hit.is_mesh = False
            # Plane ONB texture coords (w3e1.wgsl:232-255): abs() like the
            # device integrator.
            rel = (hit.position - p).astype(F)
            hit.uv = np.array(
                [abs(dot(rel, tg)), abs(dot(rel, bn))], F
            )
            hit.textured = bool(txd)
            has = True
    for (v0, v1, v2, sh, bc) in scene.tris:
        if intersect_triangle(ray, hit, v0, v1, v2):
            hit.shader = sh
            hit.base_color = bc
            hit.emission = v3(0.0)
            hit.is_mesh = False
            has = True
    if scene.mesh_vertices is not None:
        # Vectorized closest-hit over all triangles (still independent of
        # the jnp code path).
        V = scene.mesh_vertices
        I = scene.mesh_indices
        v0 = V[I[:, 0]]
        v1 = V[I[:, 1]]
        v2 = V[I[:, 2]]
        e0 = v1 - v0
        e1 = v2 - v0
        n = np.cross(e0, e1).astype(F)
        o_to_v0 = (v0 - ray.o).astype(F)
        nom = np.cross(o_to_v0, ray.d).astype(F)
        denom = (e0[:, 0] * 0 + np.einsum("j,ij->i", ray.d, n)).astype(F)
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.einsum("ij,ij->i", nom, e1) / denom
            gamma = -np.einsum("ij,ij->i", nom, e0) / denom
            t = np.einsum("ij,ij->i", o_to_v0, n) / denom
            # Degenerate denominators produce inf/NaN; every comparison
            # with them is False, and the isfinite pin makes the exclusion
            # explicit (rather than warned past — advisor round-3 finding).
            ok = (
                np.isfinite(t)
                & (beta >= 0)
                & (gamma >= 0)
                & (beta + gamma <= 1)
                & (t >= ray.tmin)
                & (t <= ray.tmax)
            )
        if ok.any():
            ids = np.nonzero(ok)[0]
            best = ids[np.argmin(t[ids])]
            tt = F(t[best])
            ray.tmax = tt
            hit.dist = tt
            hit.position = ray.at(tt)
            bb, gg = F(beta[best]), F(gamma[best])
            if scene.use_vertex_normals and scene.mesh_normals is not None:
                n0 = scene.mesh_normals[I[best, 0]]
                n1 = scene.mesh_normals[I[best, 1]]
                n2 = scene.mesh_normals[I[best, 2]]
                sn = n0 * (1 - bb - gg) + n1 * bb + n2 * gg
                if dot(sn, sn) <= 1e-20:
                    sn = n[best]
            else:
                sn = n[best]
            hit.normal = normalize(sn.astype(F))
            hit.shader = scene.mesh_shader
            mid = int(scene.mesh_matids[best])
            hit.material = mid
            hit.base_color = scene.mat_diffuse[mid].astype(F)
            hit.emission = scene.mat_emission[mid].astype(F)
            hit.is_mesh = True
            has = True
    return has


def intersect_mesh_only(scene: OracleScene, ray: Ray, cfg) -> bool:
    """Trimesh-only occlusion — ``intersect_trimesh_immediate_return`` as
    the holdout shader uses it (w9e2.wgsl:514-538)."""
    if scene.mesh_vertices is None:
        return False
    sub = OracleScene()
    sub.mesh_vertices = scene.mesh_vertices
    sub.mesh_normals = scene.mesh_normals
    sub.mesh_indices = scene.mesh_indices
    sub.mesh_matids = scene.mesh_matids
    sub.mat_diffuse = scene.mat_diffuse
    sub.mat_emission = scene.mat_emission
    sub.mesh_shader = scene.mesh_shader
    return intersect_scene(sub, ray, HitRec(), cfg)


# --- Scalar texture sampling (mirrors tracer.render.texture semantics) ----


def _tex_decode(texel, rgbe: bool):
    rgb = texel[:3].astype(F)
    if rgbe:
        rgb = rgb * F(2.0) ** (texel[3] * F(255.0) - F(128.0))
    return rgb.astype(F)


def sample_nearest_np(img, rgbe, u, v):
    h, w = img.shape[0], img.shape[1]
    uu = u - np.floor(u)
    vv = v - np.floor(v)
    x = min(int(uu * w), w - 1)
    y = min(int(vv * h), h - 1)
    return _tex_decode(img[y, x], rgbe)


def sample_bilinear_np(img, rgbe, u, v):
    h, w = img.shape[0], img.shape[1]
    uu = F(u - np.floor(u))
    vv = F(v - np.floor(v))
    fx = uu * w - F(0.5)
    fy = vv * h - F(0.5)
    x0 = np.floor(fx)
    y0 = np.floor(fy)
    tx = F(fx - x0)
    ty = F(fy - y0)
    x0i = int(x0) % w
    y0i = int(y0) % h
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h
    c00 = _tex_decode(img[y0i, x0i], rgbe)
    c10 = _tex_decode(img[y0i, x1i], rgbe)
    c01 = _tex_decode(img[y1i, x0i], rgbe)
    c11 = _tex_decode(img[y1i, x1i], rgbe)
    top = c00 * (F(1.0) - tx) + c10 * tx
    bot = c01 * (F(1.0) - tx) + c11 * tx
    return (top * (F(1.0) - ty) + bot * ty).astype(F)


def sample_np(img, rgbe, u, v, mode):
    """Sampler-mode dispatch (w3e4.wgsl:196-216): Default/Bilinear ->
    bilinear, Nearest -> nearest."""
    if mode == 3:
        return sample_nearest_np(img, rgbe, u, v)
    return sample_bilinear_np(img, rgbe, u, v)


def environment_np(scene: OracleScene, direction):
    """Lat-long environment lookup (w9e2.wgsl:234-246)."""
    d = normalize(direction)
    u = F(0.5) * (F(1.0) + F(np.arctan2(d[0], -d[2])) / PIF)
    v = F(np.arccos(np.clip(-d[1], -1.0, 1.0))) / PIF
    return sample_bilinear_np(
        scene.env_img, scene.env_rgbe, u, F(1.0) - v
    )


def albedo_of(scene: OracleScene, cfg, hit: HitRec):
    """Albedo with optional plane texture: fract(uv * uv_scale) through the
    uniform-selected sampler (integrator._plane_albedo parity)."""
    if (
        getattr(cfg, "plane_texture", False)
        and scene.texture_img is not None
        and hit.textured
        and scene.tex_mode != 0
    ):
        uv = hit.uv * scene.uv_scale
        u = F(uv[0] - np.floor(uv[0]))
        v = F(uv[1] - np.floor(uv[1]))
        return sample_np(scene.texture_img, False, u, v, scene.tex_mode)
    return hit.base_color


def rotate_to_normal(normal, v):
    signbit = F(np.sign(normal[2] + F(1.0e-16)))
    a = F(-1.0) / (F(1.0) + abs(normal[2]))
    b = normal[0] * normal[1] * a
    t0 = v3(1.0 + normal[0] * normal[0] * a, b, -signbit * normal[0])
    t1 = v3(signbit * b, signbit * (1.0 + normal[1] * normal[1] * a), -normal[1])
    return (t0 * v[0] + t1 * v[1] + normal * v[2]).astype(F)


def cosine_hemisphere(normal, rng_: Rng):
    xi1 = rng_.rnd()
    xi2 = rng_.rnd()
    thet = F(np.arccos(np.sqrt(1.0 - xi1)))
    phi = F(2.0 * np.pi) * xi2
    tang = v3(
        np.sin(thet) * np.cos(phi), np.sin(thet) * np.sin(phi), np.cos(thet)
    )
    return rotate_to_normal(normalize(normal), tang)


def fresnel_r(cos_i, cos_t, ni_over_nt):
    ii = ni_over_nt * cos_i
    tt = cos_t
    ti = cos_i
    it = ni_over_nt * cos_t
    r1 = (ii - tt) / (ii + tt)
    r2 = (ti - it) / (ti + it)
    return F(0.5) * (r1 * r1 + r2 * r2)


def sample_area_light_mc(scene: OracleScene, pos, slot: int, rng_: Rng):
    tri = scene.light_indices[slot]
    I = scene.mesh_indices[tri]
    v0 = scene.mesh_vertices[I[0]]
    v1 = scene.mesh_vertices[I[1]]
    v2 = scene.mesh_vertices[I[2]]
    e0 = v0 - v1
    e1 = v0 - v2
    cr = cross(e0, e1)
    area = F(0.5) * F(np.sqrt(dot(cr, cr)))
    l_e = scene.mat_emission[int(scene.mesh_matids[tri])]
    psi1 = F(np.sqrt(rng_.rnd()))
    psi2 = rng_.rnd()
    alpha = F(1.0) - psi1
    beta = (F(1.0) - psi2) * psi1
    gamma = psi2 * psi1
    nrm = normalize(cross(e0, e1))
    p = v0 * alpha + v1 * beta + v2 * gamma
    d = (p - pos).astype(F)
    dist = F(np.sqrt(dot(d, d)))
    w_i = normalize(d)
    cos_l = max(dot(-w_i, nrm), F(0.0))
    l_i = (l_e * area * cos_l / (dist * dist)).astype(F)
    return l_i, w_i, dist


def shade_path(scene, cfg, ray: Ray, hit: HitRec, rng_: Rng):
    """w8e3-family shade. Mutates ray/hit; returns color."""
    sid = hit.shader
    if sid == 0:  # lambertian
        brdf = (albedo_of(scene, cfg, hit) / PIF).astype(F)
        emission = hit.emission
        diffuse = v3(0.0)
        L = len(scene.light_indices)
        if "area_mc" in cfg.lights and L > 0:
            idx = rng_.rnd_int() % L
            l_i, w_i, dist = sample_area_light_mc(scene, hit.position, idx, rng_)
            sray = Ray(w_i, hit.position, tmax=dist - F(cfg.eta), tmin=F(cfg.eta))
            tmp = HitRec()
            blocked = intersect_scene(scene, sray, tmp, cfg)
            if not blocked:
                diffuse = (
                    brdf * saturate(dot(hit.normal, w_i)) * l_i * F(L)
                ).astype(F)
                if cfg.diffuse_factor:
                    diffuse = (diffuse * hit.factor).astype(F)
        elif "directional" in cfg.lights:
            w_i = -normalize(np.array(cfg.dir_light_direction, F))
            l_i = np.array(cfg.dir_light_intensity, F)
            sray = Ray(
                w_i, hit.position,
                tmax=F(999999.0) - F(cfg.eta), tmin=F(cfg.eta),
            )
            tmp = HitRec()
            if not intersect_scene(scene, sray, tmp, cfg):
                diffuse = (brdf * saturate(dot(hit.normal, w_i)) * l_i).astype(F)
                if cfg.diffuse_factor:
                    diffuse = (diffuse * hit.factor).astype(F)
        ambient = v3(0.0)
        if hit.emit or not cfg.emit_gating:
            ambient = emission.astype(F)
        if cfg.emission_factor:
            ambient = (ambient * hit.factor).astype(F)
        if not cfg.rr:
            return (diffuse + ambient).astype(F)
        hit.factor = (hit.factor * brdf * PIF).astype(F)
        prob = F((brdf[0] + brdf[1] + brdf[2]) / 3.0)
        step = rng_.rnd()
        if step < prob:
            d = cosine_hemisphere(hit.normal, rng_)
            ray.d = d
            ray.o = hit.position
            ray.tmin = F(cfg.eta)
            ray.tmax = F(cfg.tmax)
            hit.has_hit = False
            hit.emit = False
            hit.factor = (hit.factor / prob).astype(F)
        return (diffuse + ambient).astype(F)
    if sid == 2:  # mirror
        n = hit.normal
        ray.d = reflect(ray.d, n)
        ray.o = (hit.position + n * F(cfg.eta)).astype(F)
        ray.tmin = F(cfg.eta)
        ray.tmax = F(cfg.tmax)
        hit.has_hit = False
        hit.emit = True
        return v3(0.0)
    if sid == 5:
        return ((hit.normal + 1.0) * 0.5).astype(F)
    if sid == 6:
        return (albedo_of(scene, cfg, hit) + hit.emission).astype(F)
    if sid == 8:  # holdout (w9e2.wgsl:514-538): cosine AO probe vs trimesh
        ao_dir = cosine_hemisphere(normalize(hit.normal), rng_)
        aoray = Ray(ao_dir, hit.position, tmax=F(cfg.tmax), tmin=F(cfg.eta))
        if intersect_mesh_only(scene, aoray, cfg):
            return v3(0.0)
        if scene.env_img is not None:
            env = environment_np(scene, ray.d)
        else:
            env = np.array(cfg.bg_color, F)
        return (env * hit.factor).astype(F)
    if sid == 7:  # transparent, w8e3 "absorb" variant
        w_i = -normalize(ray.d)
        normal = normalize(hit.normal)
        cos_raw = dot(w_i, normal)
        if cos_raw < 0.0:  # entering
            cos_i = dot(w_i, -normal)
            out_normal = -normal
            ior = hit.ior
            cos_t2 = F(1.0) - (ior * ior) * (F(1.0) - cos_i * cos_i)
            refl = F(1.0) if cos_t2 < 0 else fresnel_r(cos_i, F(np.sqrt(cos_t2)), ior)
            tangent = out_normal * cos_i - w_i
            w_t = (ior * tangent - out_normal * F(np.sqrt(max(cos_t2, 0.0)))).astype(F)
            ray.d = w_t
            ray.o = hit.position
            ray.tmin = F(cfg.eta)
            ray.tmax = F(cfg.tmax)
            hit.has_hit = False
            hit.emit = True
            step = rng_.rnd()
            if step < refl:
                hit.normal = out_normal
                return shade_mirror_inner(cfg, ray, hit)
            return v3(0.0)
        else:  # exiting
            cos_i = cos_raw
            ior = F(1.0) / hit.ior
            out_normal = normal
            s = F(np.sqrt(dot(hit.position - ray.o, hit.position - ray.o)))
            s = s / F(cfg.beer_distance_scale)
            t_r = np.exp(-hit.extinction * s).astype(F)
            trans_prob = F((t_r[0] + t_r[1] + t_r[2]) / 3.0)
            cos_t2 = F(1.0) - (ior * ior) * (F(1.0) - cos_i * cos_i)
            refl = F(1.0) if cos_t2 < 0 else fresnel_r(cos_i, F(np.sqrt(cos_t2)), ior)
            tangent = out_normal * cos_i - w_i
            w_t = (ior * tangent - out_normal * F(np.sqrt(max(cos_t2, 0.0)))).astype(F)
            ray.d = w_t
            ray.o = hit.position
            ray.tmin = F(cfg.eta)
            ray.tmax = F(cfg.tmax)
            hit.has_hit = False
            hit.emit = True
            step = rng_.rnd()
            if step < refl:
                hit.normal = out_normal
                return shade_mirror_inner(cfg, ray, hit)
            if step < refl + trans_prob:
                hit.factor = (hit.factor * t_r / (refl + trans_prob)).astype(F)
                return v3(0.0)
            hit.has_hit = True
            return v3(0.0)
    return v3(0.7, 0.0, 0.7)


def shade_mirror_inner(cfg, ray: Ray, hit: HitRec):
    n = hit.normal
    # note: ray.d here was already replaced by w_t; the reference reflects
    # the *current* ray direction, matching mirror() called on the mutated r.
    ray.d = reflect(ray.d, n)
    ray.o = (hit.position + n * F(cfg.eta)).astype(F)
    ray.tmin = F(cfg.eta)
    ray.tmax = F(cfg.tmax)
    hit.has_hit = False
    hit.emit = True
    return v3(0.0)


def shade_direct(scene, cfg, ray: Ray, hit: HitRec, cam_eye):
    sid = hit.shader
    if sid == 0:  # lambertian (w1/w2 family)
        alb = albedo_of(scene, cfg, hit)
        blocked = False
        diffuse = v3(0.0)
        for kind in cfg.lights:
            if kind == "point_w1":
                lp = np.array(cfg.point_light_pos, F)
                li = np.array(cfg.point_light_intensity, F)
                d = (lp - hit.position).astype(F)
                dist2 = dot(d, d)
                l_i = (li / (dist2 * dist2)).astype(F)
                w_i = d
            elif kind == "directional":
                w_i = -normalize(np.array(cfg.dir_light_direction, F))
                l_i = np.array(cfg.dir_light_intensity, F)
            elif kind == "directional_n":
                # project.wgsl:286-293 / w6e1.wgsl:288-293: the lightIndices
                # loop body ``break``s after the first iteration — exactly
                # one unscaled directional sample, no shadow ray.
                w_i = -normalize(np.array(cfg.dir_light_direction, F))
                diffuse = diffuse + alb * (
                    dot(hit.normal, w_i)
                    * np.array(cfg.dir_light_intensity, F)
                    / PIF
                )
                continue
            else:
                continue
            if cfg.shadows:
                sray = Ray(
                    w_i, hit.position + hit.normal * F(cfg.eta),
                    tmax=F(cfg.tmax), tmin=F(cfg.eta),
                )
                tmp = HitRec()
                blocked = blocked or intersect_scene(scene, sray, tmp, cfg)
            diffuse = diffuse + alb * (
                dot(hit.normal, w_i) * l_i * (F(1.0) - hit.specular) / PIF
            )
        if "area_all" in cfg.lights:
            for slot in range(len(scene.light_indices)):
                tri = scene.light_indices[slot]
                I = scene.mesh_indices[tri]
                v0 = scene.mesh_vertices[I[0]]
                v1 = scene.mesh_vertices[I[1]]
                v2 = scene.mesh_vertices[I[2]]
                e0 = v0 - v1
                e1 = v0 - v2
                cr = cross(e0, e1)
                area = F(0.5) * F(np.sqrt(dot(cr, cr)))
                l_e = scene.mat_emission[int(scene.mesh_matids[tri])]
                center = ((v0 + v1 + v2) / 3.0).astype(F)
                d = (center - hit.position).astype(F)
                dist = F(np.sqrt(dot(d, d)))
                w_i = normalize(d)
                nrm = normalize(cross(e0, e1))
                cos_l = dot(-w_i, nrm)
                l_i = (l_e * area * cos_l / (dist * dist)).astype(F)
                sray = Ray(w_i, hit.position, tmax=dist - F(cfg.eta), tmin=F(cfg.eta))
                tmp = HitRec()
                if not intersect_scene(scene, sray, tmp, cfg):
                    diffuse = diffuse + alb * dot(hit.normal, w_i) * l_i / PIF
        if cfg.ambient in ("mix", "mix_ka"):
            # "mix_ka": w6e1.wgsl:295-297 mixes in Ka (material.ambient,
            # carried as hit.emission for mesh hits) instead of base color.
            if cfg.ambient == "mix_ka" and hit.is_mesh:
                ambient = hit.emission
            else:
                ambient = alb
            if cfg.shadows and blocked:
                return (ambient * F(0.1)).astype(F)
            return (F(0.9) * diffuse + F(0.1) * ambient).astype(F)
        if cfg.ambient == "plain_scaled":
            return (diffuse + F(0.1) * hit.emission).astype(F)
        return (diffuse + hit.emission).astype(F)
    if sid == 1:  # phong
        return phong(scene, cfg, ray, hit, cam_eye)
    if sid == 2:
        n = hit.normal
        ray.d = reflect(ray.d, n)
        ray.o = (hit.position + n * F(cfg.eta)).astype(F)
        ray.tmin = F(cfg.eta)
        ray.tmax = F(cfg.tmax)
        hit.has_hit = False
        return v3(0.0)
    if sid in (3, 4):  # transmit / glossy
        color = phong(scene, cfg, ray, hit, cam_eye) if sid == 4 else v3(0.0)
        w_i = -normalize(ray.d)
        normal = normalize(hit.normal)
        cos_i = dot(w_i, normal)
        ior = hit.ior
        if cos_i < 0.0:
            out_normal = -normal
        else:
            ior = F(1.0) / ior
            out_normal = normal
        cos_t2 = F(1.0) - (ior * ior) * (F(1.0) - cos_i * cos_i)
        if cos_t2 < 0.0:
            return color + v3(0.7, 0.0, 0.7)
        tangent = normal * cos_i - w_i
        w_t = (ior * tangent - out_normal * F(np.sqrt(cos_t2))).astype(F)
        ray.o = (hit.position + w_t * F(cfg.eta)).astype(F)
        ray.d = w_t
        ray.tmin = F(cfg.eta)
        ray.tmax = F(cfg.tmax)
        hit.has_hit = False
        return color
    if sid == 5:
        return ((hit.normal + 1.0) * 0.5).astype(F)
    if sid == 6:
        return (albedo_of(scene, cfg, hit) + hit.emission).astype(F)
    return v3(0.7, 0.0, 0.7)


def phong(scene, cfg, ray, hit, cam_eye):
    w_o = normalize(cam_eye - hit.position)
    lp = np.array(cfg.point_light_pos, F)
    li = np.array(cfg.point_light_intensity, F)
    d = (lp - hit.position).astype(F)
    dist2 = dot(d, d)
    l_i = (li / (dist2 * dist2)).astype(F)
    w_i = d
    w_r = normalize(reflect(-w_i, hit.normal))
    diffuse = saturate(dot(hit.normal, w_i)) * l_i / PIF
    coeff = hit.specular * (hit.shininess + F(2.0)) / (F(2.0) * PIF)
    return (coeff * saturate(dot(w_o, w_r)) ** hit.shininess * diffuse).astype(F)


def get_camera_ray(cam, u, v, jitter, cfg):
    eye = np.array(cam["eye"], F)
    target = np.array(cam["target"], F)
    up = np.array(cam["up"], F)
    fwd = normalize(target - eye)
    b1 = normalize(cross(fwd, up))
    b2 = cross(b1, fwd)
    q = (
        b1 * ((u + jitter[0]) * F(cam["aspect"]))
        + b2 * (v + jitter[1])
        + fwd * F(cam["constant"])
    )
    return Ray(normalize(q), eye, tmax=F(cfg.tmax), tmin=F(cfg.eta))


def render(scene: OracleScene, cfg, cam, iteration: int = 0) -> np.ndarray:
    """Render one sample pass; returns (H, W, 3) float32 linear radiance."""
    w, hgt = cfg.width, cfg.height
    img = np.zeros((hgt, w, 3), F)
    jitters = [np.zeros(2, F)]
    if cfg.mode != "path" and getattr(cfg, "subdivs", 1) > 1:
        from tracer_torch.math.sampling import compute_jitters

        jitters = list(compute_jitters(1.0 / hgt, cfg.subdivs))
    for py in range(hgt):
        for px in range(w):
            u = F((px + 0.5) / w - 0.5)
            v = F(0.5 - (py + 0.5) / hgt)
            launch_idx = py * w + px
            acc = v3(0.0)
            if cfg.mode == "path":
                rng_ = Rng(tea_seed(launch_idx, iteration))
                jit = np.array([rng_.rnd() / F(hgt), rng_.rnd() / F(hgt)], F)
                acc = _trace_pixel(scene, cfg, cam, u, v, jit, rng_)
            else:
                for jit in jitters:
                    rng_ = Rng(tea_seed(launch_idx, iteration))
                    acc = acc + _trace_pixel(scene, cfg, cam, u, v, jit, rng_)
                acc = acc / F(len(jitters))
            img[py, px] = acc
    return img


def _trace_pixel(scene, cfg, cam, u, v, jitter, rng_):
    ray = get_camera_ray(cam, u, v, jitter, cfg)
    result = v3(0.0)
    hit = HitRec()
    cam_eye = np.array(cam["eye"], F)
    for _ in range(cfg.max_depth):
        hit.has_hit = True
        if intersect_scene(scene, ray, hit, cfg):
            if cfg.mode == "path":
                c = shade_path(scene, cfg, ray, hit, rng_)
            else:
                c = shade_direct(scene, cfg, ray, hit, cam_eye)
            if cfg.firefly_clamp > 0:
                c = np.minimum(c, F(cfg.firefly_clamp))
            result = result + c
        else:
            if getattr(cfg, "env_light", False) and scene.env_img is not None:
                result = result + environment_np(scene, ray.d) * hit.factor
            else:
                result = result + np.array(cfg.bg_color, F)
            break
        if hit.has_hit:
            break
        # re-arm the ray interval for the continuation bounce
        hit.dist = F(0)
    return result.astype(F)

"""The reference of a path-mode frame cell in a room lit by its emissive
triangles (``w8e3.wgsl``, the ``w8e1/2/3`` rows of the upstream's
Cornell box): one path per (checked pixel, frame counter) lane, up to
``max_depth`` bounces, and the progressive mean over the window's frames.

* The camera ray is jittered from the pixel's TEA-seeded MCG31 stream
  (``w8e3.wgsl:254-259``), as in ``path_env_frames.py``.
* The closest hit folds over the stated spheres in order, then over every
  triangle of the mesh, the interval's far end shrinking to each hit found
  (``w8e3.wgsl:290-311``). A sphere's normal points out of it; a
  triangle's is its face normal.
* A Lambertian hit (shader 0, ``w8e3.wgsl:455-509``): next-event
  estimation by one sample of the light triangles: the light drawn as
  ``rnd_int % L``, a point on it by the sqrt-barycentric warp of two draws
  (``w9e2.wgsl:406-433``), a shadow ray over the spheres and the mesh from
  ``eta`` to ``dist - eta``, and ``kd/pi * saturate(n.w) * Le * area *
  max(0, -w.n_L) / dist^2 * L * throughput`` where it is not blocked; the
  emission, where the path's ``emit`` flag is set, times the throughput;
  then Russian roulette with probability mean(kd/pi), and a
  cosine-weighted continuation that clears ``emit``. The draws come in the
  shader's order: light, warp's two, roulette, the continuation's two.
* The mirror (shader 2, ``w8e3.wgsl:512-525``): the reflected ray from the
  hit offset by ``n * eta``; ``emit`` set.
* The absorbing dielectric (shader 7, ``w8e3.wgsl:527-617``): Fresnel's
  ``R`` (1 under total internal reflection), one draw choosing reflection
  (``step < R``), transmission (``step < R + P_t``) or absorption, which
  ends the path; ``emit`` set. The shader's exit test is a non-negative
  cosine between ``w_i = -d`` and the sphere's outward normal; there it
  takes the ratio 1 / ior and the Beer-Lambert transmittance ``T_r =
  exp(-extinction * |hit - o| / beer_distance_scale)`` over the segment
  that ended at the hit, ``P_t = mean(T_r)``, and a transmitted exit
  multiplies the throughput by ``T_r / (R + P_t)``; elsewhere it takes the
  ratio ior, ``T_r = 1`` and ``P_t = 1``. With the outward normal, the
  segment the shader absorbs over is the one that arrives at the sphere
  from outside.
* Departure from textbook Fresnel, as the shader has it
  (``w8e3.wgsl:560-566``): the reflected ray reflects the *refracted*
  direction about the normal on the incident side, because the shader
  calls ``mirror`` after the ray was replaced by the refracted one.
* A miss adds ``bg_color``. Each bounce's colour is clamped at
  ``firefly_clamp`` per channel (``w8e3.wgsl:250,267``) before it is added.

Only the arms and settings above are modelled: a configuration that
states others is refused.
"""

from __future__ import annotations

import torch

from benchmark import inputs as inp
from benchmark.reference import compare, objfile
from benchmark.reference import render as R

F32 = torch.float32
LAMBERTIAN, MIRROR, DIELECTRIC = 0, 2, 7
# The shading this reference models; the configuration must state it so.
MODELLED = {"mode": "path", "lights": ["area_mc"], "env_light": False, "rr": True,
            "emit_gating": True, "emission_factor": True, "diffuse_factor": True,
            "dielectric": "absorb", "use_vertex_normals": False}


class Room:
    """The scene as tensors on the device: the mesh's Möller terms, unit
    face normals, per-face ``kd`` and emission, the light triangles, and
    the spheres (centre, radius, shader, base colour, ior, extinction)."""

    def __init__(self, mesh: objfile.Mesh, mesh_shader: int, device, r):
        t = lambda x: torch.as_tensor(x, dtype=F32, device=device)
        self.V, self.I = t(mesh.V), torch.as_tensor(mesh.I.astype("int64"), device=device)
        self.terms = R.mesh_terms(self.V, self.I, r)
        self.face_n = R.normalize(self.terms[3], r)
        self.kd, self.emission = t(mesh.kd), t(mesh.emission)
        self.lights = torch.as_tensor(mesh.light.nonzero()[0], device=device)
        self.mesh_shader = int(mesh_shader)
        self.spheres = [(t(c), t(rad), int(sh), t(bc), t(ior), t(ext))
                        for c, rad, sh, bc, ior, ext in mesh.spheres]
        for sh in [s[2] for s in self.spheres] + [self.mesh_shader]:
            if sh not in (LAMBERTIAN, MIRROR, DIELECTRIC):
                raise ValueError(f"shader {sh} is not modelled")


def sphere_hit(o, d, tmin, tmax, center, radius, r=R.exact):
    """(t, hit) of rays against a sphere (``intersect_sphere``,
    ``w9e2.wgsl:353-380``): the near root where it lies in [tmin, tmax],
    else the far root."""
    oc = o - center
    a = R.dot(d, d, r)
    b2 = R.dot(oc, d, r)
    c = R.dot(oc, oc, r) - r(radius) * r(radius)
    disc = r(b2) * r(b2) - r(a) * r(c)
    pos = disc > 0.0
    sq = torch.where(pos, R.sqrt32(torch.where(pos, disc, 1.0)), 0.0)
    r0 = (-b2 - sq) / a
    r1 = (-b2 + sq) / a
    ok0 = (r0 >= tmin) & (r0 <= tmax)
    ok1 = (r1 >= tmin) & (r1 <= tmax)
    return torch.where(ok0, r0, r1), (disc >= 0.0) & (ok0 | ok1)


def closest(room: Room, o, d, tmin, tmax, r=R.exact):
    """(what, t, triangle) of each ray's closest hit: ``what`` the sphere's
    index, ``len(room.spheres)`` for the mesh, -1 for a miss."""
    n = o.shape[0]
    best = tmax.clone()
    what = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for i, (c, rad, *_) in enumerate(room.spheres):
        t, ok = sphere_hit(o, d, tmin, best, c, rad, r)
        best = torch.where(ok, t, best)
        what = torch.where(ok, i, what)
    tri = R.closest_brute(o, d, tmin, best, room.terms, r)
    on_mesh = tri >= 0
    k = tri.clamp_min(0)
    v0, e0, e1, nrm = (x[k] for x in room.terms)
    t_mesh = R.moller(o, d, v0, e0, e1, nrm, r)[0]
    best = torch.where(on_mesh, t_mesh, best)
    what = torch.where(on_mesh, len(room.spheres), what)
    return what, best, tri


def occluded(room: Room, o, w, tmin, tmax, r=R.exact):
    """Whether each shadow ray meets a sphere or a triangle with tmin <= t
    <= tmax (the shader reuses its closest-hit query, ``w8e3.wgsl:469-471``,
    and reads only whether it hit)."""
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for c, rad, *_ in room.spheres:
        blocked |= sphere_hit(o, w, tmin, tmax, c, rad, r)[1]
    v0, e0, e1, nrm = room.terms
    step = max(1, R.PAIR_BUDGET // v0.shape[0])
    for a in range(0, o.shape[0], step):
        sl = slice(a, a + step)
        t, beta, gamma = R.moller(o[sl, None], w[sl, None], v0[None], e0[None], e1[None],
                                  nrm[None], r)
        blocked[sl] |= R._accept(t, beta, gamma, tmin[sl, None], tmax[sl, None]).any(dim=1)
    return blocked


def _reflect(d, n, r=R.exact):
    """WGSL ``reflect``: d - 2 dot(d, n) n."""
    return d - r(2.0 * R.dot(d, n, r))[:, None] * r(n)


def _mean(x):
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) / torch.tensor(3.0, dtype=F32, device=x.device)


def _pi(device):
    return torch.tensor(R.PI, dtype=F32, device=device)


def lambertian(room: Room, sc: dict, pos, nrm, kd, emission, factor, emit, state,
               r=R.exact):
    """(colour, continues, direction, factor', emit', state') of Lambertian
    hits: the light's sample and shadow ray, the gated emission, Russian
    roulette and the cosine-weighted continuation."""
    dev = pos.device
    n = pos.shape[0]
    eta = float(sc["eta"])
    brdf = kd / _pi(dev)
    L = int(room.lights.shape[0])
    # Next-event estimation: the light, then a point on it.
    _, state = R.rnd(state)
    lt = room.lights[state % L]
    idx = room.I[lt]
    v0, v1, v2 = room.V[idx[:, 0]], room.V[idx[:, 1]], room.V[idx[:, 2]]
    le = room.emission[lt]
    psi1, state = R.rnd(state)
    psi2, state = R.rnd(state)
    psi1 = R.sqrt32(psi1)
    alpha, beta, gamma = 1.0 - psi1, (1.0 - psi2) * psi1, psi2 * psi1
    p = (r(v0) * r(alpha)[:, None] + r(v1) * r(beta)[:, None]) + r(v2) * r(gamma)[:, None]
    to_light = p - pos
    dist = R.sqrt32(R.dot(to_light, to_light, r))
    w = R.normalize(to_light, r)
    cr = R.cross(v0 - v1, v0 - v2, r)
    area = 0.5 * R.sqrt32(R.dot(cr, cr, r))
    cos_l = torch.clamp_min(R.dot(-w, R.normalize(cr, r), r), 0.0)
    l_i = r(le) * r(r(area) * r(cos_l) / (r(dist) * r(dist)))[:, None]
    full = lambda x: torch.full((n,), x, dtype=F32, device=dev)
    blocked = occluded(room, pos, w, full(eta), dist - eta, r)
    cos_n = torch.clamp(R.dot(nrm, w, r), 0.0, 1.0)
    direct = r(r(r(brdf) * r(cos_n)[:, None]) * r(l_i)) * float(L)
    direct = torch.where(blocked[:, None], 0.0, r(direct) * r(factor))
    glow = torch.where(emit[:, None], emission, 0.0)
    color = direct + r(glow) * r(factor)
    # Russian roulette, then the continuation.
    f_new = r(r(factor) * r(brdf)) * r(_pi(dev))
    prob = _mean(brdf)
    step, state = R.rnd(state)
    cont = step < prob
    new_d, st_cont = R.cosine_hemisphere(nrm, state, r)
    state = torch.where(cont, st_cont, state)
    factor = torch.where(cont[:, None], f_new / prob[:, None], f_new)
    emit = emit & ~cont
    return color, cont, new_d, factor, emit, state


def _fresnel(cos_i, cos_t, ratio, r=R.exact):
    """Fresnel's unpolarised reflectance for the ratio ior_i / ior_t
    (``fresnel_r``, ``w9e2.wgsl:193-203``)."""
    ii, it = r(ratio) * r(cos_i), r(ratio) * r(cos_t)
    r1 = (ii - cos_t) / (ii + cos_t)
    r2 = (cos_i - it) / (cos_i + it)
    return 0.5 * (r(r1) * r(r1) + r(r2) * r(r2))


def dielectric(sc: dict, o, d, pos, nrm, ior, extinction, factor, state, r=R.exact):
    """(origin, direction, continues, factor', state') of dielectric hits."""
    dev = pos.device
    eta = float(sc["eta"])
    w_i = -R.normalize(d, r)
    nrm = R.normalize(nrm, r)
    cos_raw = R.dot(w_i, nrm, r)
    # The shader's exit test: cos(w_i, n) >= 0 is an exit.
    exit_ = cos_raw >= 0.0
    cos_i = cos_raw.abs()
    ratio = torch.where(exit_, 1.0 / ior, ior)
    side_n = torch.where(exit_[:, None], nrm, -nrm)
    seg = pos - o
    s = R.sqrt32(R.dot(seg, seg, r)) / torch.tensor(float(sc["beer_distance_scale"]),
                                                   dtype=F32, device=dev)
    t_r = torch.where(exit_[:, None], R.f64(torch.exp, -extinction * s[:, None]), 1.0)
    p_t = torch.where(exit_, _mean(t_r), 1.0)
    cos_t2 = 1.0 - r(r(ratio) * r(ratio)) * r(1.0 - r(cos_i) * r(cos_i))
    tir = cos_t2 < 0.0
    cos_t = R.sqrt32(torch.clamp_min(cos_t2, 0.0))
    refl = torch.where(tir, 1.0, _fresnel(cos_i, cos_t, ratio, r))
    w_t = r(ratio)[:, None] * r(r(side_n) * r(cos_i)[:, None] - w_i) \
        - r(side_n) * r(cos_t)[:, None]
    step, state = R.rnd(state)
    reflect = step < refl
    transmit = ~reflect & (step < refl + p_t)
    new_o = torch.where(reflect[:, None], pos + r(side_n) * eta, pos)
    new_d = torch.where(reflect[:, None], _reflect(w_t, side_n, r), w_t)
    gain = r(factor) * r(t_r) / torch.clamp_min(refl + p_t, 1e-8)[:, None]
    factor = torch.where((transmit & exit_)[:, None], gain, factor)
    return new_o, new_d, reflect | transmit, factor, state


def radiance(room: Room, sc: dict, basis, width: int, height: int, pix, iters, r=R.exact):
    """Radiance of one path per (pixel, frame counter) lane."""
    dev = pix.device
    n = pix.shape[0]
    state = R.tea_seed(pix, iters)
    j1, state = R.rnd(state)
    j2, state = R.rnd(state)
    hh = torch.tensor(float(height), dtype=F32, device=dev)
    u, v = R.pixel_uv(width, height, pix, dev)
    d = R.ray_dirs(basis, u + j1 / hh, v + j2 / hh, r)
    o = basis[0].expand(n, 3).clone()
    eta, tmax = float(sc["eta"]), float(sc["tmax"])
    bg = torch.tensor(sc["bg_color"], dtype=F32, device=dev)
    clamp = float(sc["firefly_clamp"])
    S = len(room.spheres)
    shader_of = torch.tensor([s[2] for s in room.spheres] + [room.mesh_shader], device=dev)
    result = torch.zeros((n, 3), dtype=F32, device=dev)
    factor = torch.ones((n, 3), dtype=F32, device=dev)
    emit = torch.ones(n, dtype=torch.bool, device=dev)
    live = torch.arange(n, device=dev)
    for _ in range(int(sc["max_depth"])):
        if live.numel() == 0:
            break
        ol, dl = o[live], d[live]
        full = lambda x: torch.full((live.shape[0],), x, dtype=F32, device=dev)
        what, t, tri = closest(room, ol, dl, full(eta), full(tmax), r)
        miss = what < 0
        result[live[miss]] += bg
        hit = ~miss
        lh, what, t, tri, ol, dl = live[hit], what[hit], t[hit], tri[hit], ol[hit], dl[hit]
        pos = ol + r(t)[:, None] * r(dl)
        m = lh.shape[0]
        nrm = room.face_n[tri.clamp_min(0)]
        kd = room.kd[tri.clamp_min(0)]
        emission = room.emission[tri.clamp_min(0)]
        ior = torch.zeros(m, dtype=F32, device=dev)
        ext = torch.zeros((m, 3), dtype=F32, device=dev)
        for i, (c, _, _, bc, s_ior, s_ext) in enumerate(room.spheres):
            on = what == i
            nrm = torch.where(on[:, None], R.normalize(pos - c, r), nrm)
            kd = torch.where(on[:, None], bc, kd)
            emission = torch.where(on[:, None], 0.0, emission)
            ior = torch.where(on, s_ior, ior)
            ext = torch.where(on[:, None], s_ext, ext)
        shader = shader_of[what]
        color = torch.zeros((m, 3), dtype=F32, device=dev)
        cont = torch.zeros(m, dtype=torch.bool, device=dev)
        new_o, new_d = pos.clone(), dl.clone()
        f, e, st = factor[lh], emit[lh], state[lh]
        a = shader == LAMBERTIAN
        if bool(a.any()):
            color[a], cont[a], new_d[a], f[a], e[a], st[a] = lambertian(
                room, sc, pos[a], nrm[a], kd[a], emission[a], f[a], e[a], st[a], r)
        a = shader == MIRROR
        if bool(a.any()):
            new_o[a] = pos[a] + r(nrm[a]) * eta
            new_d[a] = _reflect(dl[a], nrm[a], r)
            cont[a], e[a] = True, True
        a = shader == DIELECTRIC
        if bool(a.any()):
            new_o[a], new_d[a], cont[a], f[a], st[a] = dielectric(
                sc, ol[a], dl[a], pos[a], nrm[a], ior[a], ext[a], f[a], st[a], r)
            e[a] = True
        if clamp > 0.0:
            color = torch.clamp_max(color, clamp)
        result[lh] += color
        factor[lh], emit[lh], state[lh] = f, e, st
        o[lh], d[lh] = new_o, new_d
        live = lh[cont]
    return result


def output(c, inputs: dict, seed: int, mesh, frames: int, device, r):
    """(accumulator at the checked pixels, every checked pixel judged)."""
    conf = c.config
    if not isinstance(mesh, objfile.Mesh):
        raise ValueError("path_area_frames needs a configuration on a model file (obj)")
    sc = inp.scene_config(conf, c.traffic)
    for k, want in MODELLED.items():
        if sc.get(k) != want:
            raise ValueError(f"path_area_frames models {k} = {want!r}, not {sc.get(k)!r}")
    room = Room(mesh, sc["mesh_shader"], device, r)
    W, H = conf["width"], conf["height"]
    basis = R.camera_basis(inputs["camera"], device, r)
    pix = inp.checked_pixels(conf, c.traffic["check"], seed, frames, device)
    P = pix.shape[0]
    lanes_pix = pix.repeat(frames)
    lanes_it = torch.arange(frames, device=device).repeat_interleave(P) + inputs["start"]
    rad = radiance(room, sc, basis, W, H, lanes_pix, lanes_it, r)
    accum = R.accumulate(iter(rad.reshape(frames, P, 3)), inputs["start"])
    return accum, torch.ones(P, dtype=torch.bool, device=device)


def numbers(prog, answer, judged) -> dict:
    return compare.frame_numbers(prog, answer, judged)

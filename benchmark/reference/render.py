"""The plain reference renderer's shared parts.

Plain PyTorch, written from the upstream renderer's shaders (the
``02562_raytracer`` WGSL files that each configuration's ``source``
names) and from the configuration files under ``benchmark/configs``; it
imports nothing of the program and takes nothing the program made. Its
inputs are the benchmark's own: the stand-in mesh from the frozen
generator (``standin.py``), the seeded environment (``env.py``), the
camera and the frame counters the harness drew from the seed
(``benchmark/inputs.py``). The references that a workload names
(``direct_frames.py``, ``path_env_frames.py``, ``direct_grad.py``) build
on these parts:

* camera rays through pixel centres (``get_camera_ray``), with path
  mode's jitter from the per-pixel TEA-seeded MCG31 stream
  (``w8e3.wgsl:254-259``, ``w9e2.wgsl:132-166``);
* the closest hit by testing every triangle (Möller-Trumbore as
  ``intersect_triangle_indexed``, ``w9e2.wgsl:309-351``): for primary
  rays only the triangles whose screen box holds the pixel's tile
  (``closest_primary``), for other rays every triangle
  (``closest_brute``); least t wins, equal t the lower id;
* shadow rays against every triangle whose box, seen along the light,
  holds the ray's origin (``occluded_parallel``);
* the shading normal, the lat-long environment lookup, the
  cosine-hemisphere direction and the progressive mean ``(result + accum
  * i) / (i + 1)`` (``w8e3.wgsl:277-278``).

``r`` rounds the operands of every product in the geometry and the
shading: ``exact`` leaves float32 alone, ``tf32`` rounds them to TF32's
10-bit mantissa, as a tensor core would. The TF32 reference is the
control the comparison must reject.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
PI = 3.14159265359  # the shaders' constant
MCG31_A = 1977654935
MASK32 = 0xFFFFFFFF


def exact(x):
    return x


def tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even); gradients pass through the rounding unchanged."""
    b = x.detach().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return x + (b.view(F32) - x).detach()


PRECISIONS = {"exact": exact, "tf32": tf32}


def dot(a, b, r=exact):
    a, b = r(a), r(b)
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a, b, r=exact):
    a, b = r(a), r(b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def sqrt32(x):
    return torch.sqrt(x.double()).to(F32)


def normalize(a, r=exact):
    return a / sqrt32(dot(a, a, r))[..., None]


def f64(fn, *xs):
    """A transcendental evaluated in float64 and rounded to float32."""
    return fn(*(x.double() for x in xs)).to(F32)


# --- camera -----------------------------------------------------------------


def camera_basis(cam: dict, device, r=exact):
    """(eye, fwd, b1, b2, aspect, constant) as float32 tensors."""
    t = lambda x: torch.tensor(x, dtype=F32, device=device)
    eye, target, up = t(cam["eye"]), t(cam["target"]), t(cam["up"])
    fwd = normalize(target - eye, r)
    b1 = normalize(cross(fwd, up, r), r)
    b2 = cross(b1, fwd, r)
    return eye, fwd, b1, b2, t(cam["aspect"]), t(cam["constant"])


def pixel_uv(width: int, height: int, pix, device):
    """The quad coords of pixels ``pix`` (row-major, row 0 at the top)."""
    px = (pix % width).to(F32)
    py = (pix // width).to(F32)
    u = (px + 0.5) / torch.tensor(float(width), dtype=F32, device=device) - 0.5
    v = 0.5 - (py + 0.5) / torch.tensor(float(height), dtype=F32, device=device)
    return u, v


def ray_dirs(basis, u, v, r=exact):
    """Unit directions through quad coords (u, v) (jitter already added)."""
    _, fwd, b1, b2, aspect, constant = basis
    q = (r(b1) * r(u * aspect)[:, None] + r(b2) * r(v)[:, None]) + r(fwd) * r(constant)
    return normalize(q, r)


# --- random streams ---------------------------------------------------------


def tea_seed(v0, v1, rounds: int = 16):
    """The TEA hash of two u32 counters, in int64 masked to 32 bits."""
    v0 = v0.to(torch.int64) & MASK32
    v1 = torch.as_tensor(v1, dtype=torch.int64, device=v0.device).expand_as(v0) & MASK32
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4))
                    & MASK32)) & MASK32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761E))
                    & MASK32)) & MASK32
    return v0


def rnd(state):
    """(uniform float32 in [0, 1), next state) of the MCG31 stream."""
    state = (state * MCG31_A) & 0x7FFFFFFF
    return state.to(F32) * (1.0 / 2147483648.0), state


# --- intersection -----------------------------------------------------------


def mesh_terms(V, I, r=exact):
    """Per-triangle (v0, e0, e1, n) of the Möller test."""
    idx = I.long()
    v0, v1, v2 = V[idx[:, 0]], V[idx[:, 1]], V[idx[:, 2]]
    e0, e1 = v1 - v0, v2 - v0
    return v0, e0, e1, cross(e0, e1, r)


def moller(o, d, v0, e0, e1, n, r=exact):
    """(t, beta, gamma) of rays (o, d) against triangles, broadcast."""
    o_to_v0 = v0 - o
    nom = cross(o_to_v0, d, r)
    denom = dot(d, n, r)
    beta = dot(nom, e1, r) / denom
    gamma = -dot(nom, e0, r) / denom
    t = dot(o_to_v0, n, r) / denom
    return t, beta, gamma


def _accept(t, beta, gamma, tmin, tmax):
    return (torch.isfinite(t) & (beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
            & (t >= tmin) & (t <= tmax))


def _pack(t, ids):
    """int64 keys that order (t, id) pairs with t > 0 by t, then by id."""
    return (t.contiguous().view(torch.int32).to(torch.int64) << 32) | ids.to(torch.int64)


NO_HIT = torch.iinfo(torch.int64).max


def _unpack(key):
    hit = key != NO_HIT
    ids = torch.where(hit, key & MASK32, -1)
    return hit, ids


PAIR_BUDGET = 1 << 23  # (ray, triangle) pairs per chunk of temporaries


def closest_brute(o, d, tmin, tmax, terms, r=exact):
    """Triangle id (-1 for none) of each ray's closest hit over every
    triangle; tmin must be > 0."""
    v0, e0, e1, n = terms
    T = v0.shape[0]
    step = max(1, PAIR_BUDGET // T)
    ids = torch.arange(T, device=o.device)
    out = torch.empty(o.shape[0], dtype=torch.int64, device=o.device)
    for a in range(0, o.shape[0], step):
        sl = slice(a, a + step)
        t, beta, gamma = moller(o[sl, None], d[sl, None], v0[None], e0[None], e1[None], n[None],
                                r)
        ok = _accept(t, beta, gamma, tmin[sl, None], tmax[sl, None])
        key = torch.where(ok, _pack(torch.where(ok, t, 1.0), ids[None]), NO_HIT)
        out[sl] = _unpack(key.amin(dim=1))[1]
    return out


TILE = 8  # pixels per side of a binning tile


def closest_primary(basis, width: int, height: int, jitter, tmin: float, tmax: float,
                    V, I, r=exact):
    """(triangle id or -1, ray directions) of the closest hit of every
    pixel's camera ray through the pixel centre plus ``jitter`` (the same
    (2,) offset for all). Each triangle is tested against the pixels of the
    8x8 tiles that its screen box, widened by one pixel, overlaps: a
    pinhole maps the triangle onto the triangle of its projected corners,
    so no pixel outside the box can see it. Triangles with a corner behind
    the eye are tested against every tile."""
    dev = V.device
    eye, fwd, b1, b2, aspect, constant = basis
    N = width * height
    pix = torch.arange(N, device=dev)
    u, v = pixel_uv(width, height, pix, dev)
    dirs = ray_dirs(basis, u + jitter[0], v + jitter[1], r)
    terms = mesh_terms(V, I, r)
    # Screen boxes, in float64 pixel units.
    rel = (V - eye).double()
    z = rel @ fwd.double()
    x = rel @ b1.double()
    y = rel @ b2.double()
    front = z > 1e-12
    zs = torch.where(front, z, 1.0)
    px = (constant.double() * x / (aspect.double() * zs) - float(jitter[0]) + 0.5) * width - 0.5
    py = (0.5 - (constant.double() * y / zs - float(jitter[1]))) * height - 0.5
    idx = I.long()
    cx, cy = px[idx], py[idx]
    behind = ~front[idx].all(dim=1)
    ntx, nty = -(-width // TILE), -(-height // TILE)
    lo_x = torch.floor((cx.amin(1) - 1.0) / TILE)
    hi_x = torch.floor((cx.amax(1) + 1.0) / TILE)
    lo_y = torch.floor((cy.amin(1) - 1.0) / TILE)
    hi_y = torch.floor((cy.amax(1) + 1.0) / TILE)
    lo_x = torch.where(behind, 0.0, lo_x)
    lo_y = torch.where(behind, 0.0, lo_y)
    hi_x = torch.where(behind, ntx - 1.0, hi_x)
    hi_y = torch.where(behind, nty - 1.0, hi_y)
    seen = (hi_x >= 0) & (lo_x <= ntx - 1) & (hi_y >= 0) & (lo_y <= nty - 1)
    tx0 = lo_x.clamp(0, ntx - 1).long()
    tx1 = hi_x.clamp(0, ntx - 1).long()
    ty0 = lo_y.clamp(0, nty - 1).long()
    ty1 = hi_y.clamp(0, nty - 1).long()
    wx = tx1 - tx0 + 1
    cnt = torch.where(seen, wx * (ty1 - ty0 + 1), 0)
    tri = torch.repeat_interleave(torch.arange(I.shape[0], device=dev), cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    k = torch.arange(tri.shape[0], device=dev) - first
    tx = tx0[tri] + k % wx[tri]
    ty = ty0[tri] + k // wx[tri]
    oy, ox = torch.meshgrid(torch.arange(TILE, device=dev), torch.arange(TILE, device=dev),
                            indexing="ij")
    best = torch.full((N,), NO_HIT, dtype=torch.int64, device=dev)
    step = max(1, PAIR_BUDGET // (TILE * TILE))
    v0, e0, e1, n = terms
    for a in range(0, tri.shape[0], step):
        tr = tri[a:a + step]
        qx = tx[a:a + step, None] * TILE + ox.reshape(1, -1)
        qy = ty[a:a + step, None] * TILE + oy.reshape(1, -1)
        inside = (qx < width) & (qy < height)
        p = torch.where(inside, qy * width + qx, 0)
        t, beta, gamma = moller(eye, dirs[p], v0[tr, None], e0[tr, None], e1[tr, None],
                                n[tr, None], r)
        ok = _accept(t, beta, gamma, tmin, tmax) & inside
        key = torch.where(ok, _pack(torch.where(ok, t, 1.0), tr[:, None].expand_as(p)), NO_HIT)
        best.scatter_reduce_(0, p.reshape(-1), key.reshape(-1), "amin")
    return _unpack(best)[1], dirs


def occluded_parallel(o, w, tmin: float, tmax: float, V, I, r=exact, cells: int = 256):
    """Whether each ray from ``o`` along the one direction ``w`` hits a
    triangle with tmin <= t <= tmax. Origins and corners are projected
    along ``w`` onto a grid of ``cells`` x ``cells``; each triangle is
    tested against the rays whose grid cell its projected box, widened by
    one cell, overlaps (a ray can only meet a triangle whose projection
    holds its origin's)."""
    dev = o.device
    wd = w.double()
    helper = torch.tensor([1.0, 0.0, 0.0] if abs(float(wd[0])) < 0.9 else [0.0, 1.0, 0.0],
                          dtype=torch.float64, device=dev)
    a1 = torch.linalg.cross(wd, helper)
    a1 = a1 / a1.norm()
    a2 = torch.linalg.cross(wd, a1)
    pv = torch.stack([V.double() @ a1, V.double() @ a2], dim=-1)
    po = torch.stack([o.double() @ a1, o.double() @ a2], dim=-1)
    lo = torch.minimum(pv.amin(0), po.amin(0))
    hi = torch.maximum(pv.amax(0), po.amax(0))
    h = (hi - lo).clamp_min(1e-12) / cells
    cell_of = lambda q: ((q - lo) / h).floor().long().clamp(0, cells - 1)
    oc = cell_of(po)
    ray_cell = oc[:, 0] * cells + oc[:, 1]
    order = torch.argsort(ray_cell)
    counts = torch.bincount(ray_cell, minlength=cells * cells)
    starts = torch.cumsum(counts, 0) - counts
    idx = I.long()
    c = pv[idx]  # (T, 3, 2)
    clo = cell_of(c.amin(1) - h)
    chi = cell_of(c.amax(1) + h)
    wx = chi[:, 0] - clo[:, 0] + 1
    cnt = wx * (chi[:, 1] - clo[:, 1] + 1)
    tri = torch.repeat_interleave(torch.arange(I.shape[0], device=dev), cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    k = torch.arange(tri.shape[0], device=dev) - first
    cell = (clo[tri, 0] + k % wx[tri]) * cells + clo[tri, 1] + k // wx[tri]
    # Expand each (triangle, cell) pair by the rays of its cell.
    n_rays = counts[cell]
    keep = n_rays > 0
    tri, cell, n_rays = tri[keep], cell[keep], n_rays[keep]
    blocked = torch.zeros(o.shape[0], dtype=torch.int32, device=dev)
    v0, e0, e1, n = mesh_terms(V, I, r)
    budget = PAIR_BUDGET
    csum = torch.cumsum(n_rays, 0)
    a = 0
    while a < tri.shape[0]:
        base = int(csum[a - 1]) if a else 0
        b = int(torch.searchsorted(csum, torch.tensor(base + budget, device=dev), right=True))
        b = max(b, a + 1)
        tr, ce, nr = tri[a:b], cell[a:b], n_rays[a:b]
        pair = torch.repeat_interleave(torch.arange(tr.shape[0], device=dev), nr)
        j = torch.arange(pair.shape[0], device=dev) - torch.repeat_interleave(
            torch.cumsum(nr, 0) - nr, nr)
        ray = order[starts[ce[pair]] + j]
        t, beta, gamma = moller(o[ray], w.expand(ray.shape[0], 3), v0[tr[pair]], e0[tr[pair]],
                                e1[tr[pair]], n[tr[pair]], r)
        ok = _accept(t, beta, gamma, tmin, tmax)
        blocked.scatter_reduce_(0, ray, ok.to(torch.int32), "amax")
        a = b
    return blocked > 0


# --- shading ----------------------------------------------------------------


def hit_normals(o, d, ids, V, Nv, I, r=exact):
    """(position, unit shading normal) of hits ``ids`` (all >= 0): the
    Möller barycentrics of the winning triangle, the vertex normals
    interpolated with them (the face normal where they cancel)."""
    idx = I.long()[ids]
    v0, v1, v2 = V[idx[:, 0]], V[idx[:, 1]], V[idx[:, 2]]
    n0, n1, n2 = Nv[idx[:, 0]], Nv[idx[:, 1]], Nv[idx[:, 2]]
    e0, e1 = v1 - v0, v2 - v0
    n = cross(e0, e1, r)
    t, beta, gamma = moller(o, d, v0, e0, e1, n, r)
    pos = o + r(t)[:, None] * r(d)
    w0 = (1.0 - beta - gamma)[:, None]
    sn = (r(n0) * r(w0) + r(n1) * r(beta[:, None])) + r(n2) * r(gamma[:, None])
    sn = torch.where((dot(sn, sn, r) > 1e-20)[:, None], sn, n)
    return pos, normalize(sn, r)


def light_dir(scene: dict, device):
    d = torch.tensor(scene["dir_light_direction"], dtype=F32, device=device)
    return -normalize(d)


def environment(env, d):
    """Bilinear lat-long lookup of plain RGB texels (w9e1.wgsl): u = (1 +
    atan2(x, -z) / pi) / 2, v = acos(-y) / pi, sampled at (u, 1 - v)."""
    dev = d.device
    pi = torch.tensor(math.pi, dtype=F32, device=dev)
    u = 0.5 * (1.0 + f64(torch.atan2, d[:, 0], -d[:, 2]) / pi)
    v = f64(torch.acos, torch.clamp(-d[:, 1], -1.0, 1.0)) / pi
    v = 1.0 - v
    h, w = env.shape[0], env.shape[1]
    fx = (u - torch.floor(u)) * w - 0.5
    fy = (v - torch.floor(v)) * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
    x0i, y0i = torch.remainder(x0.long(), w), torch.remainder(y0.long(), h)
    x1i, y1i = torch.remainder(x0i + 1, w), torch.remainder(y0i + 1, h)
    rgb = env[..., :3]
    top = rgb[y0i, x0i] * (1.0 - tx) + rgb[y0i, x1i] * tx
    bot = rgb[y1i, x0i] * (1.0 - tx) + rgb[y1i, x1i] * tx
    return top * (1.0 - ty) + bot * ty


def cosine_hemisphere(nrm, state, r=exact):
    """(direction, state) of the cosine-weighted hemisphere about ``nrm``
    (w8e3.wgsl:492-509, the Frisvad/Duff basis of w9e2.wgsl:169-181)."""
    xi1, state = rnd(state)
    xi2, state = rnd(state)
    theta = f64(torch.acos, sqrt32(1.0 - xi1))
    phi = (2.0 * math.pi) * xi2
    st, ct = f64(torch.sin, theta), f64(torch.cos, theta)
    tang = torch.stack([r(st) * r(f64(torch.cos, phi)), r(st) * r(f64(torch.sin, phi)), ct], -1)
    n = normalize(nrm, r)
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    sign = torch.sign(nz + 1.0e-16)
    a = -1.0 / (1.0 + nz.abs())
    b = r(nx) * r(ny) * r(a)
    t0 = torch.stack([1.0 + r(nx) * r(nx) * r(a), b, -sign * nx], -1)
    t1 = torch.stack([sign * b, sign * (1.0 + r(ny) * r(ny) * r(a)), -ny], -1)
    out = (r(t0) * r(tang[:, 0:1]) + r(t1) * r(tang[:, 1:2])) + r(n) * r(tang[:, 2:3])
    return out, state


def accumulate(frames, start: int, accum=None):
    """The progressive mean after ``frames`` (an iterable of (M, 3)
    radiances) at counters start, start + 1, ...: accum = (accum * i +
    result) / (i + 1) in float32."""
    for k, rad in enumerate(frames):
        i = start + k
        if accum is None:
            accum = torch.zeros_like(rad)
        accum = (accum * float(i) + rad) / torch.tensor(float(i + 1), dtype=F32,
                                                        device=rad.device)
    return accum


def device_mesh(mesh_np, device):
    """The (vertices, normals, indices) arrays as tensors on ``device``."""
    return tuple(torch.as_tensor(x, device=device) for x in mesh_np)

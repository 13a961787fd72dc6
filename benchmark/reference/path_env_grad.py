"""The reference of a path-mode gradient cell lit by the environment alone
(``w9e1.wgsl``): the gradient of the frame's L2 loss, mean((image -
target)^2) over the whole (H * W, 3) image against the seeded target,
where the image is one path a pixel seeded at frame counter 0 (the
program's ``render_radiance(scene, cfg, 0)``).

Plain PyTorch autograd, float32, through ``render.py``'s parts. Each
lane's path is ``path_env_frames.radiance``'s: the camera ray jittered from
the pixel's TEA-seeded MCG31 stream, up to ``max_depth`` Lambertian
bounces, each continued with probability p = mean(albedo / pi) along a
cosine-weighted direction with the throughput scaled by albedo / p, and
the lat-long environment times the throughput where a segment escapes.
The closest hit of each segment is found under ``no_grad`` by testing
every triangle (``closest_brute``), and the hit is then derived again from
the leaves: the Möller t and barycentrics of the winning triangle, the
position, the interpolated vertex normal. The roulette's draw and decision
and the continuation's two draws are held fixed, as the program holds
them. So the gradient reaches:

* the camera's five leaves (its basis and the jittered directions; the
  eye is the first origin);
* the vertices and vertex normals of every hit, through t, the position
  (the next segment's origin), the shading normal and the direction
  built about it;
* the material's diffuse, through albedo / pi * pi / p on each continued
  bounce: the roulette's 1 / p carries a gradient too;
* the material's emission, which the path Lambertian adds times the
  throughput where the path's ``emit`` flag holds (``w8e3.wgsl:475-478``):
  the flag starts set and a continued bounce clears it, so a path adds it
  at its first hit only. It is zero in value, not in gradient;
* the environment's texels, through the bilinear lookup of each escaping
  direction (normalised, so that its gradient is the lookup's through the
  normalisation), and that direction.

The Lambertian reads neither the specular, the shininess nor the ior:
their gradients are zero, as are the program's ``uniforms.uv_scale`` and
``geom.tri_table`` (derived data), which this module leaves out.

Departures from ``w9e1.wgsl``:

* discrete events are held fixed by the sample (the triangle each segment
  hits, the roulette's decision), as the program's gradient holds them,
  so the estimator is biased at silhouettes;
* one path a pixel at counter 0 and no progressive mean: the loss is over
  one sample pass;
* square roots, acos, sin, cos and atan2 are taken in float64 and rounded
  to float32 (``render.py``), where the shader takes float32.

Lanes go in chunks of ``CHUNK``: each chunk's loss is its share of the
frame's mean, and the chunks' gradients are summed, so that only one
chunk's autograd graph is held at a time. TF32 is off.
"""

from __future__ import annotations

import torch

from benchmark import inputs as inp
from benchmark.reference import compare, env as ref_env
from benchmark.reference import render as R

F32 = torch.float32
CAMERA_LEAVES = ("eye", "target", "up", "constant", "aspect")
MATERIAL_LEAVES = ("diffuse", "emission", "specular", "shininess", "ior")
CHUNK = 1 << 16  # lanes whose autograd graph is held at once
# The shading this reference models, where the configuration states it.
MODELLED = {"mode": "path", "lights": ["none"], "env_light": True, "use_vertex_normals": True}


def _leaves(cam: dict, mesh, material: dict, env) -> dict:
    """{leaf key: float32 tensor that requires grad}, keyed as the
    program's gradient is."""
    V, Nv, _ = mesh
    dev = V.device
    t = lambda x: torch.tensor(x, dtype=F32, device=dev).requires_grad_(True)
    leaves = {f"camera.{k}": t(cam[k]) for k in CAMERA_LEAVES}
    leaves["geom.vertices"] = V.clone().requires_grad_(True)
    leaves["geom.normals"] = Nv.clone().requires_grad_(True)
    for k in MATERIAL_LEAVES:
        leaves[f"materials.{k}"] = t([material[k]])
    leaves["env.data"] = env.clone().requires_grad_(True)
    return leaves


def _basis(leaves: dict, r):
    eye, tgt, up = (leaves[f"camera.{k}"] for k in ("eye", "target", "up"))
    fwd = R.normalize(tgt - eye, r)
    b1 = R.normalize(R.cross(fwd, up, r), r)
    b2 = R.cross(b1, fwd, r)
    return eye, fwd, b1, b2, leaves["camera.aspect"], leaves["camera.constant"]


def _chunk_image(scene: dict, leaves: dict, I, terms, width: int, height: int, pix, r):
    """(n, 3) radiance of the lanes ``pix`` at counter 0, as a function of
    the leaves."""
    dev = pix.device
    n = pix.shape[0]
    V, Nv, env = leaves["geom.vertices"], leaves["geom.normals"], leaves["env.data"]
    basis = _basis(leaves, r)
    state = R.tea_seed(pix, 0)
    j1, state = R.rnd(state)
    j2, state = R.rnd(state)
    hh = torch.tensor(float(height), dtype=F32, device=dev)
    u, v = R.pixel_uv(width, height, pix, dev)
    d = R.ray_dirs(basis, u + j1 / hh, v + j2 / hh, r)
    o = basis[0].expand(n, 3)
    eta, tmax = float(scene["eta"]), float(scene["tmax"])
    pi = torch.tensor(R.PI, dtype=F32, device=dev)
    brdf = leaves["materials.diffuse"][0] / pi
    prob = ((brdf[0] + brdf[1]) + brdf[2]) / torch.tensor(3.0, dtype=F32, device=dev)
    emission = leaves["materials.emission"][0]
    image = torch.zeros((n, 3), dtype=F32, device=dev)
    factor = torch.ones((n, 3), dtype=F32, device=dev)
    lane = torch.arange(n, device=dev)
    for bounce in range(int(scene["max_depth"])):
        if lane.numel() == 0:
            break
        with torch.no_grad():
            full = lambda x: torch.full((lane.shape[0],), x, dtype=F32, device=dev)
            ids = R.closest_brute(o.detach(), d.detach(), full(eta), full(tmax), terms, r)
        miss, hit = ids < 0, ids >= 0
        escaped = R.environment(env, R.normalize(d[miss], r)) * factor[miss]
        image = image.index_add(0, lane[miss], escaped)
        pos, nrm = R.hit_normals(o[hit], d[hit], ids[hit], V, Nv, I, r)
        f = factor[hit]
        if bounce == 0:
            image = image.index_add(0, lane[hit], emission * f)
        step, st = R.rnd(state[hit])
        cont = step < prob
        new_d, st = R.cosine_hemisphere(nrm[cont], st[cont], r)
        factor = (r(f[cont]) * r(brdf) * r(pi)) / prob
        o, d, state = pos[cont], new_d, st
        lane = lane[hit][cont]
    return image


def gradient(scene: dict, cam: dict, width: int, height: int, env, mesh, material: dict,
             target, r=R.exact) -> dict:
    """{leaf key: gradient} of the frame's L2 loss for the camera's five
    leaves (``camera.eye`` ...), ``geom.vertices``, ``geom.normals``, the
    one material's five (``materials.diffuse`` ...) and ``env.data``."""
    for k, want in MODELLED.items():
        if k in scene and scene[k] != want:
            raise ValueError(f"path_env_grad models {k} = {want!r}, not {scene[k]!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    V, _, I = mesh
    dev = V.device
    leaves = _leaves(cam, mesh, material, env)
    keys = list(leaves)
    total = {k: torch.zeros_like(x) for k, x in leaves.items()}
    terms = R.mesh_terms(V, I, r)
    N = width * height
    denom = torch.tensor(float(N * 3), dtype=F32, device=dev)
    for a in range(0, N, CHUNK):
        pix = torch.arange(a, min(N, a + CHUNK), device=dev)
        with torch.enable_grad():
            img = _chunk_image(scene, leaves, I, terms, width, height, pix, r)
            loss = ((img - target[pix]) ** 2).sum() / denom
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
        for k, g in zip(keys, grads):
            if g is not None:
                total[k] += g
    return total


def output(c, inputs: dict, seed: int, mesh_np, steps: int, device, r):
    """({leaf key: gradient}, None) of the last step, which is every step's."""
    conf = c.config
    W, H = conf["width"], conf["height"]
    env = torch.as_tensor(ref_env.seeded_env(False, inputs["env_seed"],
                                             tuple(conf["env"]["shape"])), device=device)
    target = inp.target(inputs, W * H, device)
    return gradient(inp.scene_config(conf, c.traffic), inputs["camera"], W, H, env,
                    R.device_mesh(mesh_np, device), conf["material"], target, r), None


def numbers(prog, answer, _aux, leaves: dict | None = None) -> dict:
    return compare.grad_numbers(prog, answer, leaves)

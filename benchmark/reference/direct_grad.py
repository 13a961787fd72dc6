"""The reference of a direct-mode gradient cell: the gradient of the
frame's L2 loss against the seeded target.

Plain PyTorch autograd through ``render.py``'s camera, Möller
barycentrics, interpolated normals and direct Lambertian: which triangle
each pixel sees is found without gradients (``closest_primary``), then
every pixel's colour is computed again from the leaves, so the gradient
holds that choice fixed, as the upstream's differentiable renderer does.
The loss is mean((image - target)^2) over the whole (H * W, 3) image.
"""

from __future__ import annotations

import torch

from benchmark import inputs as inp
from benchmark.reference import compare
from benchmark.reference import render as R
from benchmark.reference.direct_frames import direct_colour

F32 = torch.float32
CAMERA_LEAVES = ("eye", "target", "up", "constant", "aspect")
MATERIAL_LEAVES = ("diffuse", "emission", "specular", "shininess", "ior")


def gradient(scene: dict, cam: dict, width: int, height: int, mesh, material: dict, target,
             r=R.exact) -> dict:
    """{leaf key: gradient} for the camera's five leaves
    (``camera.eye`` ...), ``geom.vertices``, ``geom.normals`` and the one
    material's five (``materials.diffuse`` ...)."""
    V, Nv, I = mesh
    dev = V.device
    with torch.no_grad():
        basis = R.camera_basis(cam, dev, r)
        zero = torch.zeros(2, dtype=F32, device=dev)
        ids, _ = R.closest_primary(basis, width, height, zero, float(scene["eta"]),
                                   float(scene["tmax"]), V, I, r)
    t = lambda x: torch.tensor(x, dtype=F32, device=dev).requires_grad_(True)
    leaves = {f"camera.{k}": t(cam[k]) for k in CAMERA_LEAVES}
    leaves["geom.vertices"] = V.clone().requires_grad_(True)
    leaves["geom.normals"] = Nv.clone().requires_grad_(True)
    mat = {"diffuse": [material["diffuse"]], "emission": [material["emission"]],
           "specular": [material["specular"]], "shininess": [material["shininess"]],
           "ior": [material["ior"]]}
    for k in MATERIAL_LEAVES:
        leaves[f"materials.{k}"] = t(mat[k])
    with torch.enable_grad():
        eye, tgt, up = (leaves[f"camera.{k}"] for k in ("eye", "target", "up"))
        fwd = R.normalize(tgt - eye, r)
        b1 = R.normalize(R.cross(fwd, up, r), r)
        b2 = R.cross(b1, fwd, r)
        basis = (eye, fwd, b1, b2, leaves["camera.aspect"], leaves["camera.constant"])
        N = width * height
        u, v = R.pixel_uv(width, height, torch.arange(N, device=dev), dev)
        hit = ids >= 0
        d = R.ray_dirs(basis, u[hit], v[hit], r)
        _, nrm = R.hit_normals(eye, d, ids[hit], leaves["geom.vertices"],
                               leaves["geom.normals"], I, r)
        n_hit = nrm.shape[0]
        albedo = leaves["materials.diffuse"][0].expand(n_hit, 3)
        emission = leaves["materials.emission"][0].expand(n_hit, 3)
        blocked = torch.zeros(n_hit, dtype=torch.bool, device=dev)
        colour = direct_colour(scene, albedo, emission, nrm, blocked, r)
        bg = torch.tensor(scene["bg_color"], dtype=F32, device=dev).expand(N, 3)
        img = torch.where(hit[:, None], torch.zeros_like(bg), bg)
        img = img.index_put((torch.nonzero(hit)[:, 0],), colour)
        loss = torch.mean((img - target) ** 2)
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    return {k: (torch.zeros_like(leaves[k]) if g is None else g).detach()
            for k, g in zip(keys, grads)}


def output(c, inputs: dict, seed: int, mesh_np, frames: int, device, r):
    """({leaf key: gradient}, None)."""
    conf = c.config
    mesh = R.device_mesh(mesh_np, device)
    target = inp.target(inputs, conf["width"] * conf["height"], device)
    return gradient(inp.scene_config(conf, c.traffic), inputs["camera"], conf["width"],
                    conf["height"], mesh, conf["material"], target, r), None


def numbers(prog, answer, _aux, leaves: dict | None = None) -> dict:
    return compare.grad_numbers(prog, answer, leaves)

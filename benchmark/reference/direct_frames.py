"""The reference of a direct-mode frame cell: the direct Lambertian of
``project.wgsl`` (``directional_n`` under ``plain_scaled``) and of
``w5e3.wgsl`` (``directional`` with a shadow ray from the hit point moved
``eta`` along the shading normal, under ``mix``), the background colour on
a miss, each pixel's camera ray through its centre, and the progressive
mean over the window's frames at the checked pixels. Direct frames draw
nothing at random, so every frame's radiance is the same."""

from __future__ import annotations

import itertools

import torch

from benchmark import inputs as inp
from benchmark.reference import compare
from benchmark.reference import render as R

F32 = torch.float32


def direct_colour(scene: dict, albedo, emission, nrm, blocked, r=R.exact):
    """The Lambertian for one directional light: ``directional_n`` with
    ``plain_scaled`` (project.wgsl:286-295), or ``directional`` under
    ``mix`` with ``blocked`` from its shadow ray (w5e3.wgsl)."""
    dev = nrm.device
    w_i = R.light_dir(scene, dev)
    l_i = torch.tensor(scene["dir_light_intensity"], dtype=F32, device=dev)
    pi = torch.tensor(R.PI, dtype=F32, device=dev)
    lights, ambient = tuple(scene["lights"]), scene["ambient"]
    if lights == ("directional_n",) and ambient == "plain_scaled":
        diffuse = r(albedo) * r((r(R.dot(nrm, w_i, r)[:, None]) * r(l_i)) / pi)
        return diffuse + 0.1 * emission
    if lights == ("directional",) and ambient == "mix":
        spec = torch.zeros((), dtype=F32, device=dev)
        diffuse = r(albedo) * r(r(R.dot(nrm, w_i, r)[:, None]) * r(l_i) * ((1.0 - spec) / pi))
        lit = 0.9 * diffuse + 0.1 * albedo
        return torch.where(blocked[:, None], albedo * 0.1, lit)
    raise NotImplementedError(f"direct shading for lights {lights}, ambient {ambient!r}")


def frame(sc: dict, basis, W: int, H: int, mesh, material: dict, r):
    """(radiance (H*W, 3), mesh hit (H*W,)) of one direct-mode frame."""
    V, Nv, I = mesh
    dev = V.device
    zero = torch.zeros(2, dtype=F32, device=dev)
    ids, dirs = R.closest_primary(basis, W, H, zero, float(sc["eta"]), float(sc["tmax"]), V, I,
                                  r)
    hit = ids >= 0
    pos, nrm = R.hit_normals(basis[0], dirs[hit], ids[hit], V, Nv, I, r)
    n_hit = pos.shape[0]
    albedo = torch.tensor(material["diffuse"], dtype=F32, device=dev).expand(n_hit, 3)
    emission = torch.tensor(material["emission"], dtype=F32, device=dev).expand(n_hit, 3)
    blocked = torch.zeros(n_hit, dtype=torch.bool, device=dev)
    if sc["shadows"] and "directional" in sc["lights"]:
        w = R.light_dir(sc, dev)
        eta = torch.tensor(float(sc["eta"]), dtype=F32, device=dev)
        blocked = R.occluded_parallel(pos + nrm * eta, w, float(sc["eta"]), float(sc["tmax"]),
                                      V, I, r)
    colour = direct_colour(sc, albedo, emission, nrm, blocked, r)
    bg = torch.tensor(sc["bg_color"], dtype=F32, device=dev)
    rad = bg.expand(W * H, 3).clone()
    rad[hit] = colour
    return rad, hit


def output(c, inputs: dict, seed: int, mesh_np, frames: int, device, r):
    """(accumulator at the checked pixels, the pixels that see the mesh)."""
    conf = c.config
    sc = inp.scene_config(conf, c.traffic)
    W, H = conf["width"], conf["height"]
    mesh = R.device_mesh(mesh_np, device)
    basis = R.camera_basis(inputs["camera"], device, r)
    rad, hit = frame(sc, basis, W, H, mesh, conf["material"], r)
    pix = inp.checked_pixels(conf, c.traffic["check"], seed, frames, device)
    return R.accumulate(itertools.repeat(rad[pix], frames), inputs["start"]), hit[pix]


def numbers(prog, answer, judged) -> dict:
    return compare.frame_numbers(prog, answer, judged)

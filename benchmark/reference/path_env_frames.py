"""The reference of a path-mode frame cell lit by the environment alone
(``w9e1.wgsl``): one path per (checked pixel, frame counter) lane, its
camera ray jittered from the pixel's TEA-seeded MCG31 stream, up to
``max_depth`` Lambertian bounces with Russian roulette and a
cosine-weighted direction, the lat-long environment on every escape, and
the progressive mean over the window's frames."""

from __future__ import annotations

import torch

from benchmark import inputs as inp
from benchmark.reference import compare, env as ref_env
from benchmark.reference import render as R

F32 = torch.float32


def radiance(scene: dict, basis, width: int, height: int, pix, iters, env, mesh, material,
             r=R.exact):
    """Radiance of one path per (pixel, frame counter) lane: each hit
    continues with probability mean(albedo / pi) along a cosine-weighted
    direction and the throughput scaled by albedo / that probability, each
    escape adding the environment times the throughput."""
    dev = pix.device
    V, Nv, I = mesh
    terms = R.mesh_terms(V, I, r)
    n = pix.shape[0]
    state = R.tea_seed(pix, iters)
    j1, state = R.rnd(state)
    j2, state = R.rnd(state)
    hh = torch.tensor(float(height), dtype=F32, device=dev)
    u, v = R.pixel_uv(width, height, pix, dev)
    d = R.ray_dirs(basis, u + j1 / hh, v + j2 / hh, r)
    o = basis[0].expand(n, 3).clone()
    eta, tmax = float(scene["eta"]), float(scene["tmax"])
    albedo = torch.tensor(material["diffuse"], dtype=F32, device=dev)
    pi = torch.tensor(R.PI, dtype=F32, device=dev)
    brdf = albedo / pi
    prob = ((brdf[0] + brdf[1]) + brdf[2]) / torch.tensor(3.0, dtype=F32, device=dev)
    result = torch.zeros((n, 3), dtype=F32, device=dev)
    factor = torch.ones((n, 3), dtype=F32, device=dev)
    live = torch.arange(n, device=dev)
    for _ in range(int(scene["max_depth"])):
        if live.numel() == 0:
            break
        ol, dl = o[live], d[live]
        full = lambda x: torch.full((live.shape[0],), x, dtype=F32, device=dev)
        ids = R.closest_brute(ol, dl, full(eta), full(tmax), terms, r)
        miss = ids < 0
        lm = live[miss]
        result[lm] += R.environment(env, R.normalize(dl[miss], r)) * factor[lm]
        lh, hid = live[~miss], ids[~miss]
        pos, nrm = R.hit_normals(ol[~miss], dl[~miss], hid, V, Nv, I, r)
        f_new = r(factor[lh]) * r(brdf) * r(pi)
        step, st = R.rnd(state[lh])
        cont = step < prob
        new_d, st_ind = R.cosine_hemisphere(nrm, st, r)
        state[lh] = torch.where(cont, st_ind, st)
        factor[lh] = torch.where(cont[:, None], f_new / prob, f_new)
        o[lh], d[lh] = pos, new_d
        live = lh[cont]
    return result


def output(c, inputs: dict, seed: int, mesh_np, frames: int, device, r):
    """(accumulator at the checked pixels, every checked pixel judged)."""
    conf = c.config
    sc = inp.scene_config(conf, c.traffic)
    W, H = conf["width"], conf["height"]
    mesh = R.device_mesh(mesh_np, device)
    basis = R.camera_basis(inputs["camera"], device, r)
    env = torch.as_tensor(ref_env.seeded_env(False, inputs["env_seed"],
                                             tuple(conf["env"]["shape"])), device=device)
    pix = inp.checked_pixels(conf, c.traffic["check"], seed, frames, device)
    P = pix.shape[0]
    lanes_pix = pix.repeat(frames)
    lanes_it = torch.arange(frames, device=device).repeat_interleave(P) + inputs["start"]
    rad = radiance(sc, basis, W, H, lanes_pix, lanes_it, env, mesh, conf["material"], r)
    accum = R.accumulate(iter(rad.reshape(frames, P, 3)), inputs["start"])
    return accum, torch.ones(P, dtype=torch.bool, device=device)


def numbers(prog, answer, judged) -> dict:
    return compare.frame_numbers(prog, answer, judged)

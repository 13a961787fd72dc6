"""Scene building: descriptor -> device ``Scene`` (port of
``tracer.scenes.build.build_scene`` for mesh rows on the treelet engines).

Loads the model (or its procedural stand-in), builds the LBVH with the
native C++ code, cuts it into treelets, uploads the mesh and the analytic
planes, gathers the block table on the device and reads the environment
map. Rows the port does not cover yet raise ``NotImplementedError`` before
any work is done.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

from tracer_torch.accel import lbvh
from tracer_torch.accel import treelet as treelet_mod
from tracer_torch.geometry import obj as obj_mod
from tracer_torch.geometry.device import (
    SHADER_HOLDOUT,
    SHADER_LAMBERTIAN,
    Planes,
    upload_mesh,
)
from tracer_torch.geometry.procedural import standin_for
from tracer_torch.render.camera import make_camera
from tracer_torch.render.scene import (
    FROM_SELECTION1,
    FROM_SELECTION2,
    Scene,
    SceneConfig,
    Uniforms,
)
from tracer_torch.scenes.registry import SceneDescriptor

TREELET_T = 1024  # triangles per treelet block


def _resolve_static(shader_code: int, desc: SceneDescriptor) -> int:
    if shader_code == FROM_SELECTION1:
        return desc.selection1
    if shader_code == FROM_SELECTION2:
        return desc.selection2
    return shader_code


def _possible_shaders(desc: SceneDescriptor) -> tuple:
    """Shader ids this scene can produce (analytic primitives + mesh
    shader, selection sentinels resolved to the descriptor's selections)."""
    ids = set()
    for s in desc.spheres:
        ids.add(_resolve_static(s[2], desc))
    for p in desc.planes:
        ids.add(_resolve_static(p[4], desc))
    for t in desc.tris:
        ids.add(_resolve_static(t[3], desc))
    if desc.model is not None:
        ids.add(_resolve_static(desc.cfg.mesh_shader, desc))
    ids.discard(255)
    return tuple(sorted(ids))


def unsupported(desc: SceneDescriptor, cfg: SceneConfig) -> list[str]:
    """Why this row is outside the ported slices ([] when it is inside):
    direct mode as ``Project: Dragon`` runs it, or path mode without lights
    on a mesh and analytic planes with the Lambertian and holdout shaders
    (``W9 E1``/``W9 E2``)."""
    why = []
    if desc.model is None:
        why.append("no triangle mesh")
    if desc.spheres or desc.tris:
        why.append("analytic spheres or triangles")
    treelet = cfg.traversal == "bvh" or (
        cfg.traversal == "bsp" and cfg.bsp_execution == "fast")
    if not treelet:
        why.append(f"traversal {cfg.traversal!r} ({cfg.bsp_execution})")
    if desc.texture or cfg.plane_texture:
        why.append("plane textures")
    if cfg.subdivs > 1:
        why.append(f"subdivs {cfg.subdivs}")
    if cfg.mode == "direct":
        if desc.planes:
            why.append("analytic planes in direct mode")
        if any(k != "directional_n" for k in cfg.lights):
            why.append(f"lights {cfg.lights}")
        if cfg.shadows:
            why.append("shadow rays")
        if cfg.ambient != "plain_scaled":
            why.append(f"ambient {cfg.ambient!r}")
        if desc.hdri or cfg.env_light:
            why.append("environment map in direct mode")
        if set(cfg.possible_shaders) - {SHADER_LAMBERTIAN}:
            why.append(f"shaders {cfg.possible_shaders}")
    elif cfg.mode == "path":
        if cfg.lights != ("none",):
            why.append(f"lights {cfg.lights} (next-event estimation)")
        if cfg.loop != "while":
            why.append(f"bounce loop {cfg.loop!r}")
        if set(cfg.possible_shaders) - {SHADER_LAMBERTIAN, SHADER_HOLDOUT}:
            why.append(f"shaders {cfg.possible_shaders}")
    else:
        why.append(f"mode {cfg.mode!r}")
    return why


def load_environment(path: str, rgbe: bool):
    """The environment map at ``path``; ``None`` (with a note on stderr)
    when the file is missing, as in the JAX package: misses then take the
    background colour. Image loaders are not ported."""
    if not os.path.exists(path):
        print(f"[build] texture '{path}' missing — scene falls back to the "
              "background color (reference lists it in .MISSING_LARGE_BLOBS)",
              file=sys.stderr)
        return None
    raise NotImplementedError(f"loading the image {path!r} is not ported")


def load_mesh(path: str, scale: float = 1.0):
    """OBJ mesh, or the procedural stand-in for an absent bunny/dragon."""
    if not os.path.exists(path):
        return standin_for(path)
    m = obj_mod.load_obj(path)
    return m.scale(scale) if scale != 1.0 else m


def build_scene(desc: SceneDescriptor, device, timings: dict | None = None):
    """Build the device scene for a descriptor; returns (Scene, SceneConfig).

    ``timings``: optional dict that receives per-stage wall seconds
    (mesh_load / accel_host / upload / device_assembly / total); device
    work is synchronized before each stage ends.
    """
    cfg = dataclasses.replace(
        desc.cfg,
        possible_shaders=_possible_shaders(desc),
        max_leaf=min(desc.cfg.max_leaf, desc.bvh_leaf),
    )
    why = unsupported(desc, cfg)
    if why:
        raise NotImplementedError(
            f"scene {desc.name!r} is outside the ported slice: " + "; ".join(why))
    marks: dict[str, float] = {}
    t_start = t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        marks[name] = t - t0
        t0 = t

    mesh = load_mesh(desc.model, desc.model_scale)
    mark("mesh_load")
    if mesh.num_triangles <= 64:
        # The JAX package traces tiny meshes by brute force, not ported yet.
        raise NotImplementedError(
            f"scene {desc.name!r}: {mesh.num_triangles}-triangle mesh takes "
            "the brute-force engine, which is outside the ported slice")
    binary = lbvh.build_for_mesh(mesh, max_prims=desc.bvh_leaf, native=True)
    host = treelet_mod.build_host(binary, T=TREELET_T)
    mark("accel_host")
    geom, materials, light_indices = upload_mesh(mesh, device)
    mark("upload")
    tb = treelet_mod.from_host(host, geom.vertices, geom.indices)
    mark("device_assembly")
    planes = None
    if desc.planes:
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
        p, nrm, tg, bn, sh, bc, txd = zip(*desc.planes)
        planes = Planes(position=f32(p), normal=f32(nrm), tangent=f32(tg),
                        binormal=f32(bn), shader=i32(sh), base_color=f32(bc),
                        textured=i32([int(t) for t in txd]))
    env = load_environment(desc.hdri, desc.hdri_rgbe) if desc.hdri else None
    scene = Scene(
        camera=make_camera(**desc.camera, device=device),
        uniforms=Uniforms(selection1=desc.selection1, selection2=desc.selection2),
        geom=geom,
        materials=materials,
        light_indices=light_indices,
        tb=tb,
        planes=planes,
        env=env,
    )
    if timings is not None:
        marks["total"] = time.perf_counter() - t_start
        timings.update(marks)
    return scene, cfg

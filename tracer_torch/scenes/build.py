"""Scene building: descriptor -> device ``Scene`` (port of
``tracer.scenes.build.build_scene``).

Uploads the analytic spheres, planes and triangles; loads the model (or its
procedural stand-in; a missing model without one raises
``FileNotFoundError``, as in the JAX package); for meshes of more than 64
triangles builds what the traversal walks, as the JAX package does: for
the treelet engines (``bvh``, and ``bsp`` with ``bsp_execution="fast"``)
the LBVH with the native C++ code, cut into treelets, with the block table
gathered on the device; for ``bvh2`` the binary LBVH; for ``bvh8`` the
8-ary BVH collapsed from it (not cached, as in the JAX package); for the
BSP walk the BSP tree (native C++ builder). Smaller meshes take the brute-force
engine and get no acceleration structure. The mesh and the treelet cut go through the disk cache
(``tracer_torch.scenes.cache``). Reads the environment map and the plane
texture (a missing file leaves it out, with the JAX package's note on
stderr) and computes direct mode's stratified jitters. Configurations the
port does not serve (``unsupported``) raise ``NotImplementedError`` before
any work is done.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from tracer_torch.accel import bsp as bsp_mod
from tracer_torch.accel import lbvh, traverse
from tracer_torch.accel import treelet as treelet_mod
from tracer_torch.accel import wide as wide_mod
from tracer_torch.geometry import obj as obj_mod
from tracer_torch.geometry.device import AnalyticTriangles, Planes, upload_mesh
from tracer_torch.geometry.procedural import standin_for
from tracer_torch.math.sampling import compute_jitters
from tracer_torch.render import texture as tex
from tracer_torch.render.camera import make_camera
from tracer_torch.scenes import cache as disk_cache
from tracer_torch.render.scene import (
    FROM_SELECTION1,
    FROM_SELECTION2,
    Scene,
    SceneConfig,
    Spheres,
    Uniforms,
)
from tracer_torch.scenes.registry import SceneDescriptor

TREELET_T = 1024  # triangles per treelet block
BRUTE_MAX_TRIANGLES = 64  # meshes this small take the brute-force engine


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


# Direct mode's light kinds and ambient terms.
DIRECT_LIGHTS = ("point_w1", "directional", "directional_n", "area_all")
AMBIENTS = ("mix", "mix_ka", "plain", "plain_scaled")


def unsupported(desc: SceneDescriptor, cfg: SceneConfig) -> list[str]:
    """Why this configuration is outside what the port serves ([] when it
    is inside; ``desc`` is not read).

    Served: direct mode with every shader arm, the ``point_w1``,
    ``directional``, ``directional_n`` and ``area_all`` lights and the four
    ambient terms, textured planes and stratified jitter; path mode with
    next-event estimation over the emissive triangles (``area_mc``), the
    sun (``directional``) or no lights; analytic spheres, planes and
    triangles and an optional mesh on the treelet engines (``bvh``, or
    ``bsp`` executed by them), the BSP walk, the ``bvh2`` or ``bvh8`` walk
    or the brute-force engine; the ``while`` or the differentiable ``scan``
    bounce loop with any ``remat`` policy; the environment map in either
    mode. Refused: what no registry row asks for (a direct-mode light kind
    outside ``DIRECT_LIGHTS``, the ``absorb_v2`` dielectric)."""
    why = []
    if cfg.traversal not in ("brute", "bvh", "bvh2", "bvh8", "bsp"):
        why.append(f"traversal {cfg.traversal!r}")
    if cfg.loop not in ("while", "scan"):
        why.append(f"bounce loop {cfg.loop!r}")
    if cfg.remat not in ("none", "full", "dots"):
        why.append(f"remat {cfg.remat!r}")
    if cfg.mode == "direct":
        if set(cfg.lights) - set(DIRECT_LIGHTS):
            why.append(f"lights {cfg.lights}")
        if cfg.ambient not in AMBIENTS:
            why.append(f"ambient {cfg.ambient!r}")
    elif cfg.mode == "path":
        if cfg.lights not in (("none",), ("area_mc",), ("directional",)):
            why.append(f"lights {cfg.lights} (next-event estimation)")
        if cfg.dielectric not in ("simple", "fresnel", "absorb"):
            why.append(f"dielectric {cfg.dielectric!r}")
    else:
        why.append(f"mode {cfg.mode!r}")
    return why


def scene_config(desc: SceneDescriptor) -> SceneConfig:
    """The row's configuration as ``build_scene`` returns it before the
    mesh is loaded: the shader ids it can produce and the leaf bound
    resolved. Raises ``NotImplementedError`` for a row outside the ported
    slices."""
    cfg = dataclasses.replace(
        desc.cfg,
        possible_shaders=_possible_shaders(desc),
        max_leaf=min(desc.cfg.max_leaf, desc.bvh_leaf),
    )
    why = unsupported(desc, cfg)
    if why:
        raise NotImplementedError(
            f"scene {desc.name!r} is outside the ported slice: " + "; ".join(why))
    return cfg


def load_texture(path: str, rgbe: bool, device):
    """The environment map or plane texture at ``path``, dispatched as the
    JAX package's ``_load_texture_cached``: a Radiance ``.hdr``, an RGBE
    ``.hdr.png`` (``rgbe``) or a plain image. ``None`` (with a note on
    stderr) when the file is missing, as in the JAX package: misses then
    take the background colour and planes their base colour. A file that
    exists and cannot be decoded raises."""
    if not os.path.exists(path):
        print(f"[build] texture '{path}' missing — scene falls back to the "
              "background color (reference lists it in .MISSING_LARGE_BLOBS)",
              file=sys.stderr)
        return None
    if path.endswith(".hdr"):
        return tex.load_radiance_hdr(path, device)
    if rgbe:
        return tex.load_rgbe_png(path, device)
    return tex.load_image(path, device)


def load_mesh(path: str, scale: float = 1.0):
    """OBJ mesh, or the procedural stand-in for an absent bunny/dragon,
    through the disk cache."""
    m = disk_cache.load_mesh(path, scale)
    if m is not None:
        return m
    if not os.path.exists(path):
        m = standin_for(path)
    else:
        m = obj_mod.load_obj(path)
        if scale != 1.0:
            m = m.scale(scale)
    disk_cache.save_mesh(path, scale, m)
    return m


def treelet_host(mesh, bvh_leaf: int):
    """The host half of the treelet build (native LBVH and treelet cut),
    through the disk cache."""
    fp = disk_cache.mesh_fingerprint(mesh)
    host = disk_cache.load_treelet_host(fp, bvh_leaf, TREELET_T)
    if host is None:
        binary = lbvh.build_for_mesh(mesh, max_prims=bvh_leaf, native=True)
        host = treelet_mod.build_host(binary, T=TREELET_T)
        disk_cache.save_treelet_host(fp, bvh_leaf, host)
    return host


def build_scene(desc: SceneDescriptor, device, timings: dict | None = None):
    """Build the device scene for a descriptor; returns (Scene, SceneConfig).

    ``timings``: optional dict that receives per-stage wall seconds
    (mesh_load / accel_host / upload / device_assembly for a mesh,
    analytic, textures, and total); device work is synchronized before each stage
    ends.
    """
    cfg = scene_config(desc)
    marks: dict[str, float] = {}
    t_start = t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        marks[name] = t - t0
        t0 = t

    geom = materials = light_indices = tb = bvh = bsp = wide = None
    if desc.model is not None:
        mesh = load_mesh(desc.model, desc.model_scale)
        mark("mesh_load")
        if mesh.num_triangles <= BRUTE_MAX_TRIANGLES and cfg.traversal in ("bvh", "bsp"):
            # A dense sweep over a tiny mesh needs no acceleration structure.
            cfg = dataclasses.replace(cfg, traversal="brute")
        host = None
        if cfg.traversal == "bvh" or (cfg.traversal == "bsp" and cfg.bsp_execution == "fast"):
            host = treelet_host(mesh, desc.bvh_leaf)
        elif cfg.traversal == "bvh2":
            bvh = traverse.to_device(lbvh.build_for_mesh(mesh, max_prims=desc.bvh_leaf), device)
        elif cfg.traversal == "bvh8":
            wide = wide_mod.build(lbvh.build_for_mesh(mesh, max_prims=desc.bvh_leaf),
                                  mesh.vertices, mesh.indices, device)
        elif cfg.traversal == "bsp":
            bsp = bsp_mod.to_device(bsp_mod.build_for_mesh(mesh), device)
        mark("accel_host")
        geom, materials, light_indices = upload_mesh(mesh, device)
        mark("upload")
        tb = None if host is None else treelet_mod.from_host(host, geom.vertices, geom.indices)
        mark("device_assembly")
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    spheres = planes = tris = None
    if desc.spheres:
        c, r, sh, bc, ior, ext = zip(*desc.spheres)
        spheres = Spheres(center=f32(c), radius=f32(r), shader=i32(sh), base_color=f32(bc),
                          ior=f32(ior), extinction=f32(ext))
    if desc.planes:
        p, nrm, tg, bn, sh, bc, txd = zip(*desc.planes)
        planes = Planes(position=f32(p), normal=f32(nrm), tangent=f32(tg),
                        binormal=f32(bn), shader=i32(sh), base_color=f32(bc),
                        textured=i32([int(t) for t in txd]))
    if desc.tris:
        v0, v1, v2, sh, bc = zip(*desc.tris)
        tris = AnalyticTriangles(verts=f32([list(v) for v in zip(v0, v1, v2)]),
                                 shader=i32(sh), base_color=f32(bc))
    mark("analytic")
    env = load_texture(desc.hdri, desc.hdri_rgbe, device) if desc.hdri else None
    texture = load_texture(desc.texture, False, device) if desc.texture else None
    mark("textures")
    jitters = None
    if cfg.mode != "path" and cfg.subdivs > 1:
        jitters = torch.as_tensor(compute_jitters(1.0 / cfg.height, cfg.subdivs), device=device)
    scene = Scene(
        camera=make_camera(**desc.camera, device=device),
        uniforms=Uniforms(selection1=desc.selection1, selection2=desc.selection2,
                          use_texture=tex.TEX_DEFAULT if desc.texture else tex.TEX_NONE,
                          uv_scale=f32((1.0, 1.0))),
        geom=geom,
        materials=materials,
        light_indices=light_indices,
        tb=tb,
        bvh=bvh,
        bsp=bsp,
        wide=wide,
        planes=planes,
        env=env,
        spheres=spheres,
        tris=tris,
        texture=texture,
        jitters=jitters,
    )
    if timings is not None:
        marks["total"] = time.perf_counter() - t_start
        timings.update(marks)
    return scene, cfg


def build_oracle_scene(desc: SceneDescriptor):
    """The CPU oracle's scene for a descriptor (port of
    ``tracer.scenes.build.build_oracle_scene``): the analytic primitives,
    the mesh through ``load_mesh`` (so the stand-ins and the disk cache
    too), the plane texture and the environment map as NumPy arrays.
    Returns (OracleScene, cfg, camera dict)."""
    from tracer_torch.oracle.cpu_tracer import OracleScene

    f32 = lambda x: np.array(x, np.float32)
    cfg = desc.cfg
    sc = OracleScene()
    for (c, r, sh, bc, ior, ext) in desc.spheres:
        sc.spheres.append((f32(c), np.float32(r), _resolve_static(sh, desc), f32(bc),
                           np.float32(ior), f32(ext)))
    for (p, n, tg, bn, sh, bc, txd) in desc.planes:
        sc.planes.append((f32(p), f32(n), f32(tg), f32(bn), _resolve_static(sh, desc), f32(bc),
                          bool(txd)))
    for (v0, v1, v2, sh, bc) in desc.tris:
        sc.tris.append((f32(v0), f32(v1), f32(v2), _resolve_static(sh, desc), f32(bc)))
    if desc.model is not None:
        mesh = load_mesh(desc.model, desc.model_scale)
        sc.mesh_vertices = mesh.vertices
        sc.mesh_normals = mesh.normals
        sc.mesh_indices = mesh.indices.astype(np.int64)
        sc.mesh_matids = np.where(mesh.mat_ids == 0xFFFFFFFF, 0, mesh.mat_ids).astype(np.int64)
        sc.mat_diffuse = np.stack([m.diffuse for m in mesh.materials])
        sc.mat_emission = np.stack([m.ambient for m in mesh.materials])
        sc.light_indices = list(mesh.light_indices())
        sc.mesh_shader = _resolve_static(cfg.mesh_shader, desc)
        sc.use_vertex_normals = cfg.use_vertex_normals
    if desc.texture:
        t = load_texture(desc.texture, False, "cpu")
        if t is not None:
            sc.texture_img = t.data.numpy()
            sc.tex_mode = tex.TEX_DEFAULT
    if desc.hdri:
        e = load_texture(desc.hdri, desc.hdri_rgbe, "cpu")
        if e is not None:
            sc.env_img = e.data.numpy()
            sc.env_rgbe = e.kind == tex.ENV_RGBE
    return sc, cfg, dict(desc.camera)

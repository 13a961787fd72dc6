"""Scene container: device tensors + static render configuration (port of
``tracer.render.scene``, and of the JAX package's ``Spheres`` container).

``SceneConfig`` is the JAX package's frozen configuration, field for field
(the analog of the reference's per-scene WGSL shader). ``Scene`` holds the
device buffers the ported path reads; ``Uniforms`` holds the runtime knobs:
the integer ones as plain Python ints (PyTorch runs eagerly, so there is
nothing to trace and no reason to keep them on the device), and
``uv_scale`` as a float32 tensor on the scene's device, since it is a float
leaf that gradients reach, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

import torch

from tracer_torch.accel.bsp import BspBuffers
from tracer_torch.accel.lbvh import BvhBuffers
from tracer_torch.accel.treelet import TreeletBvh
from tracer_torch.accel.wide import WideBvh
from tracer_torch.geometry.device import AnalyticTriangles, GeometryBuffers, MaterialTable, Planes
from tracer_torch.render.camera import Camera
from tracer_torch.render.texture import TextureBuf

# Sentinel shader values meaning "resolve from uniforms at trace time".
FROM_SELECTION1 = -1
FROM_SELECTION2 = -2


@dataclass(frozen=True)
class Spheres:
    """Analytic spheres with per-sphere shading setup (the reference hardcodes
    these per scene, e.g. ``w8e3.wgsl:293-305``)."""

    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    shader: torch.Tensor  # (S,) i32
    base_color: torch.Tensor  # (S, 3) f32
    ior: torch.Tensor  # (S,) f32: ior1_over_ior2 assigned at hit
    extinction: torch.Tensor  # (S, 3) f32: Beer-Lambert rho_t

    @cached_property
    def shader_ids(self) -> tuple:
        """The shader ids as host integers, read from the device once: the
        bounce resolves them on the host, and a read per bounce would make
        the host wait for the device."""
        return tuple(self.shader.tolist())


@dataclass(frozen=True)
class Uniforms:
    """Runtime-tunable state (mirrors ``Uniform``, uniform.rs:8-34)."""

    selection1: int = 0  # sphere/mesh material override
    selection2: int = 0  # other material override
    use_texture: int = 0  # TextureUse mode
    uv_scale: Optional[torch.Tensor] = None  # (2,) f32 on the scene's device
    iteration: int = 0  # progressive frame index (u32-valued)


@dataclass(frozen=True)
class SceneConfig:
    """Static render configuration — the WGSL-shader analog. Same fields and
    defaults as ``tracer.render.scene.SceneConfig``."""

    width: int = 512
    height: int = 512
    max_depth: int = 10  # bounce budget (MAX_DEPTH, 10 or 50)
    eta: float = 1.0e-5  # ray epsilon (per-shader ETA constant)
    tmax: float = 5000.0  # ray_init tmax
    bg_color: tuple = (0.1, 0.3, 0.6)  # miss color (per-scene bgcolor)
    mode: str = "direct"  # "direct" (w1-w6) | "path" (w7-w9)
    # light kinds evaluated by lambertian/phong: "point_w1", "directional",
    # "directional_n", "area_all", "area_mc", "none"
    lights: tuple = ("point_w1",)
    point_light_pos: tuple = (0.0, 1.2, 0.0)
    point_light_intensity: tuple = (
        5.0 * 3.14159265359,
    ) * 3  # pi * I (w1e6.wgsl:240-241)
    dir_light_direction: tuple = (-1.0, -1.0, -1.0)  # w5e2.wgsl:296
    dir_light_intensity: tuple = (5.0 * 3.14159265359,) * 3
    shadows: bool = True  # trace shadow rays in direct mode (w2+)
    # ambient/diffuse combination in direct lambertian:
    #   "mix" | "mix_ka" | "plain" | "plain_scaled" (project.wgsl:295)
    ambient: str = "mix"
    emit_gating: bool = True  # NEE double-count avoidance (w8e3.wgsl:475-478)
    rr: bool = True  # Russian-roulette indirect bounce (off in w8e1)
    emission_factor: bool = True  # emission *= factor (w8e3/w9; off in w7e3)
    diffuse_factor: bool = True  # NEE term *= factor (off in w8e1)
    dielectric: str = "absorb"  # "simple" | "fresnel" | "absorb" | "absorb_v2"
    beer_distance_scale: float = 100.0  # w8e3: s = |p - o| / 100
    firefly_clamp: float = 0.0  # min(shade, clamp) when > 0 (w8e3.wgsl:250)
    gamma: float = 1.0  # display transform exponent (pow(color, gamma))
    traversal: str = "bvh"  # "brute" | "bvh" | "bsp"
    bsp_execution: str = "fast"  # "fast": bsp scenes run the treelet engine
    use_vertex_normals: bool = True  # interpolate vs face normal
    mesh_shader: int = 0  # shader for trimesh hits; FROM_SELECTION1 for UI
    env_light: bool = False  # miss -> environment map (vs bg color)
    plane_texture: bool = False  # textured plane albedo (w3)
    progressive: bool = False  # progressive accumulation scenes (w7+)
    subdivs: int = 1  # stratified sub-pixel grid (1..10, w3e3)
    max_leaf: int = 8  # static unroll bound for BVH leaf tests
    sphere_ior_default: float = 1.5
    # Shader ids that can occur in this scene; branches for absent ids are
    # not evaluated.
    possible_shaders: tuple = (0, 1, 2, 3, 4, 5, 6, 7, 8)
    loop: str = "while"  # bounce-loop driver: "while" | "scan"
    remat: str = "none"  # rematerialization policy of the scan driver
    name: str = ""


@dataclass(frozen=True)
class Scene:
    """The device state of one scene on the ported paths. Every part but
    the camera and the uniforms may be absent: the worksheet-1 to -3 rows
    have no mesh, most rows no spheres, planes or textures."""

    camera: Camera
    uniforms: Uniforms
    geom: Optional[GeometryBuffers] = None  # triangle mesh (None: no mesh)
    materials: Optional[MaterialTable] = None  # the mesh's materials
    light_indices: Optional[torch.Tensor] = None  # (L,) i32 emissive triangle ids
    # Treelet BVH of the flat and packet engines; None on the brute-force
    # route (meshes of 64 triangles or fewer) and without a mesh.
    tb: Optional[TreeletBvh] = None
    # The binary BVH of the ``bvh2`` walk and the BSP tree of the BSP walk
    # (``bsp_execution != "fast"``), as tensors; None elsewhere.
    bvh: Optional[BvhBuffers] = None
    bsp: Optional[BspBuffers] = None
    # The 8-ary BVH of ``traversal="bvh8"``; None elsewhere.
    wide: Optional[WideBvh] = None
    planes: Optional[Planes] = None  # analytic planes (None: no planes)
    env: Optional[TextureBuf] = None  # environment map (None: bg_color)
    spheres: Optional[Spheres] = None  # analytic spheres (None: no spheres)
    tris: Optional[AnalyticTriangles] = None  # analytic triangles (None: none)
    texture: Optional[TextureBuf] = None  # plane texture (None: base colour)
    # (subdivs^2, 2) stratified sub-pixel offsets of direct mode (None: one
    # sample at the pixel's centre).
    jitters: Optional[torch.Tensor] = None
    # (first row, rows): the band of whole pixel rows this scene renders
    # (``tracer_torch.parallel.shard``); None is the whole frame. Rays,
    # random streams and jitters take the pixels' frame-wide indices.
    band: Optional[tuple] = None

    @property
    def device(self) -> torch.device:
        return self.camera.eye.device

"""Scene container: device tensors + static render configuration (port of
``tracer.render.scene``).

``SceneConfig`` is the JAX package's frozen configuration, field for field
(the analog of the reference's per-scene WGSL shader). ``Scene`` holds the
device buffers the ported path reads; ``Uniforms`` holds the runtime knobs
as plain Python ints (PyTorch runs eagerly, so there is nothing to trace
and no reason to keep them on the device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tracer_torch.accel.treelet import TreeletBvh
from tracer_torch.geometry.device import GeometryBuffers, MaterialTable, Planes
from tracer_torch.render.camera import Camera
from tracer_torch.render.texture import TextureBuf

# Sentinel shader values meaning "resolve from uniforms at trace time".
FROM_SELECTION1 = -1
FROM_SELECTION2 = -2


@dataclass(frozen=True)
class Uniforms:
    """Runtime-tunable state (mirrors ``Uniform``, uniform.rs:8-34)."""

    selection1: int = 0  # sphere/mesh material override
    selection2: int = 0  # other material override
    use_texture: int = 0  # TextureUse mode
    uv_scale: tuple = (1.0, 1.0)
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
    """The device state of one mesh scene on the ported paths."""

    camera: Camera
    uniforms: Uniforms
    geom: GeometryBuffers
    materials: MaterialTable
    light_indices: torch.Tensor  # (L,) i32 emissive triangle ids
    tb: Optional[TreeletBvh]  # treelet BVH of the flat and packet engines
    planes: Optional[Planes] = None  # analytic planes (None: no planes)
    env: Optional[TextureBuf] = None  # environment map (None: bg_color)

    @property
    def device(self) -> torch.device:
        return self.geom.vertices.device

"""Scene registry (port of ``tracer.scenes.registry``) — the 44-entry
``SceneDescriptor`` table of the reference (``reference/src/scenes.rs:98-487``)
re-expressed as integrator configs, row for row the JAX package's table.

Each reference scene couples a WGSL shader (the *algorithm*) with a camera,
model, resolution and traversal choice. Here the shader becomes a
``SceneConfig`` + analytic primitive list; the registry rows below cite the
shader file whose behavior they encode.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from tracer_torch.render.scene import FROM_SELECTION1, FROM_SELECTION2, SceneConfig

# Asset root of the reference renderer's ``res/`` tree. Models named here
# that do not exist (bunny, dragon) are replaced by procedural stand-ins at
# build time; the stand-in choice keys on the file name only.
REF_RES = os.environ.get("TRACER_REF_RES", "reference/res")

BASIC_CAM = dict(eye=(2.0, 1.5, 2.0), target=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0), constant=1.0, aspect=1.0)
TEAPOT_CAM = dict(eye=(0.15, 1.5, 10.0), target=(0.15, 1.5, 0.0), up=(0.0, 1.0, 0.0), constant=2.5, aspect=1.0)
CORNELL_CAM = dict(eye=(277.0, 275.0, -570.0), target=(277.0, 275.0, 0.0), up=(0.0, 1.0, 0.0), constant=1.0, aspect=1.0)
BUNNY_CAM = dict(eye=(-0.02, 0.11, 0.6), target=(-0.02, 0.11, 0.0), up=(0.0, 1.0, 0.0), constant=3.5, aspect=1.0)
DRAGON_CAM = BUNNY_CAM

# Analytic primitive descriptors (plain tuples; device upload in build.py).
# sphere: (center, radius, shader, base_color, ior, extinction)
# plane:  (position, normal, tangent, binormal, shader, base_color, textured)
# tri:    (v0, v1, v2, shader, base_color)

_W1_TRI = ((0.2, 0.1, 0.9), (-0.2, 0.1, -0.1), (-0.2, 0.1, 0.9))
_W1_SPHERE_C = (0.0, 0.5, 0.0)
_PLANE_ONB = dict(
    position=(0.0, 0.0, 0.0),
    normal=(0.0, 1.0, 0.0),
    tangent=(-1.0, 0.0, 0.0),
    binormal=(0.0, 0.0, 1.0),
)


def _w1_analytics(tri_shader, sphere_shader, plane_shader, textured=False):
    """The worksheet-1/2/3 analytic scene (w1e6.wgsl:142-161): brown
    triangle, black sphere, green plane."""
    return dict(
        tris=[(_W1_TRI[0], _W1_TRI[1], _W1_TRI[2], tri_shader, (0.4, 0.3, 0.2))],
        spheres=[(_W1_SPHERE_C, 0.3, sphere_shader, (0.0, 0.0, 0.0), 1.5, (0.0, 0.0, 0.0))],
        planes=[(
            _PLANE_ONB["position"], _PLANE_ONB["normal"],
            _PLANE_ONB["tangent"], _PLANE_ONB["binormal"],
            plane_shader, (0.1, 0.7, 0.0), textured,
        )],
    )


def _cornell_balls(transparent_shader):
    """w6e3/w8 analytic spheres inside the Cornell box
    (w8e3.wgsl:293-305)."""
    return dict(
        spheres=[
            ((420.0, 90.0, 370.0), 90.0, 2, (0.0, 0.0, 0.0), 1.5, (0.0, 0.0, 0.0)),
            ((130.0, 90.0, 250.0), 90.0, transparent_shader, (0.0, 0.0, 0.0), 1.5, (0.5, 0.2, 0.2)),
        ]
    )


@dataclass(frozen=True)
class SceneDescriptor:
    """Mirror of the reference ``SceneDescriptor`` (scenes.rs:20-29) plus the
    shading program encoded as config/analytics."""

    name: str
    cfg: SceneConfig
    camera: dict
    spheres: tuple = ()
    planes: tuple = ()
    tris: tuple = ()
    model: Optional[str] = None
    model_scale: float = 1.0
    hdri: Optional[str] = None  # environment image path
    hdri_rgbe: bool = False  # decode alpha as RGBE exponent
    texture: Optional[str] = None  # plane texture (grass)
    selection1: int = 0
    selection2: int = 0
    bvh_leaf: int = 4
    ref_shader: str = ""  # reference WGSL this row reproduces


def _mk(name, shader, cam, res, *, cfg_kw=None, analytics=None, **kw):
    cfg_kw = dict(cfg_kw or {})
    cfg_kw.setdefault("width", res[0])
    cfg_kw.setdefault("height", res[1])
    cfg_kw.setdefault("name", name)
    analytics = analytics or {}
    cam = dict(cam)
    cam["aspect"] = res[0] / res[1]
    return SceneDescriptor(
        name=name,
        cfg=SceneConfig(**cfg_kw),
        camera=cam,
        spheres=tuple(analytics.get("spheres", ())),
        planes=tuple(analytics.get("planes", ())),
        tris=tuple(analytics.get("tris", ())),
        ref_shader=shader,
        **kw,
    )


# Common config fragments per worksheet family.
_W1_DIRECT = dict(
    mode="direct", max_depth=10, eta=1e-5, bg_color=(0.1, 0.3, 0.6),
    gamma=1.5, lights=("point_w1",), shadows=False, ambient="mix",
    traversal="brute",
)
_W2_DIRECT = dict(_W1_DIRECT, shadows=True)
_MESH_DIRECT = dict(
    mode="direct", max_depth=10, eta=1e-5, bg_color=(0.1, 0.3, 0.6),
    gamma=1.5, shadows=True, traversal="bvh",
)
_CORNELL_PATH = dict(
    mode="path", eta=1e-2, bg_color=(0.0, 0.0, 0.0), gamma=1.5,
    lights=("area_mc",), traversal="bvh", progressive=True,
    use_vertex_normals=False,
)


def get_scenes() -> list[SceneDescriptor]:
    s = []
    add = s.append

    # --- Worksheet 1 (analytic; w1e1-e3 are constant/gradient/dir debug
    # shaders — expressed as tiny configs with no primitives).
    add(_mk("W1 E1", "w1e1.wgsl", BASIC_CAM, (512, 512),
            cfg_kw=dict(mode="direct", bg_color=(0.0, 0.0, 0.0), max_depth=1,
                        lights=(), shadows=False, traversal="brute", gamma=1.0)))
    add(_mk("W1 E2", "w1e2.wgsl", BASIC_CAM, (512, 512),
            cfg_kw=dict(mode="direct", bg_color=(0.1, 0.3, 0.6), max_depth=1,
                        lights=(), shadows=False, traversal="brute", gamma=1.0)))
    add(_mk("W1 E3", "w1e3.wgsl", BASIC_CAM, (512, 512),
            cfg_kw=dict(mode="direct", bg_color=(0.1, 0.3, 0.6), max_depth=1,
                        lights=(), shadows=False, traversal="brute", gamma=1.0)))
    # w1e4/e5: base-color shading (shader id 6); w1e6: lambertian point light.
    add(_mk("W1 E4", "w1e4.wgsl", BASIC_CAM, (512, 512),
            cfg_kw=_W1_DIRECT, analytics=_w1_analytics(6, 6, 6)))
    add(_mk("W1 E5", "w1e5.wgsl", BASIC_CAM, (512, 512),
            cfg_kw=_W1_DIRECT, analytics=_w1_analytics(6, 6, 6)))
    add(_mk("W1 E6", "w1e6.wgsl", BASIC_CAM, (512, 512),
            cfg_kw=_W1_DIRECT, analytics=_w1_analytics(0, 0, 0)))

    # --- Worksheet 2 (shadows, material selection via uniforms).
    add(_mk("W2 E1", "w2e1.wgsl", BASIC_CAM, (512, 512),
            cfg_kw=_W2_DIRECT, analytics=_w1_analytics(0, 0, 0)))
    for (nm, sh) in (("W2 E2", "w2e2.wgsl"), ("W2 E3", "w2e3.wgsl"),
                     ("W2 E4", "w2e4.wgsl"), ("W2 E5", "w2e5.wgsl")):
        add(_mk(nm, sh, BASIC_CAM, (512, 512), cfg_kw=_W2_DIRECT,
                analytics=_w1_analytics(0, FROM_SELECTION1, FROM_SELECTION2),
                selection1=2 if nm in ("W2 E2",) else 3,
                selection2=0))

    # --- Worksheet 3 (textured plane, stratified AA, sampler modes).
    for (nm, sh, subdivs) in (("W3 E1", "w3e1.wgsl", 1), ("W3 E2", "w3e2.wgsl", 1),
                              ("W3 E3", "w3e3.wgsl", 4), ("W3 E4", "w3e4.wgsl", 1)):
        add(_mk(nm, sh, BASIC_CAM, (512, 512),
                cfg_kw=dict(_W2_DIRECT, plane_texture=True, subdivs=subdivs),
                analytics=_w1_analytics(0, FROM_SELECTION1, FROM_SELECTION2),
                texture=f"{REF_RES}/textures/grass.jpg"))

    # --- Worksheet 5 (meshes: brute-force loop in the reference; we default
    # to BVH with a brute fallback config).
    add(_mk("W5 E2 Teapot", "w5e2.wgsl", TEAPOT_CAM, (800, 450),
            cfg_kw=dict(_MESH_DIRECT, lights=("directional",), shadows=True,
                        ambient="mix", use_vertex_normals=False),
            model=f"{REF_RES}/models/teapot.obj"))
    add(_mk("W5 E3 Teapot", "w5e3.wgsl", TEAPOT_CAM, (800, 450),
            cfg_kw=dict(_MESH_DIRECT, lights=("directional",), shadows=True,
                        ambient="mix", use_vertex_normals=True),
            model=f"{REF_RES}/models/teapot.obj"))
    add(_mk("W5 E4 Cornell Box", "w5e4.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_MESH_DIRECT, lights=(), mesh_shader=6,
                        use_vertex_normals=False),
            model=f"{REF_RES}/models/CornellBoxWithBlocks.obj"))
    add(_mk("W5 E5 Cornell Box", "w5e5.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_MESH_DIRECT, eta=1e-3, lights=("area_all",),
                        ambient="plain", use_vertex_normals=False),
            model=f"{REF_RES}/models/CornellBoxWithBlocks.obj"))

    # --- Worksheet 6 (accelerated traversal; e1 teapot/bunny/dragon).
    for nm, model, cam, res in (
        ("W6 E1 Teapot", "teapot.obj", TEAPOT_CAM, (800, 450)),
        ("W6 E1 Bunny", "bunny.obj", BUNNY_CAM, (512, 512)),
        ("W6 E1 Dragon", "dragon.obj", DRAGON_CAM, (800, 450)),
    ):
        add(_mk(nm, "w6e1.wgsl", cam, res,
                cfg_kw=dict(_MESH_DIRECT, lights=("directional_n",),
                            ambient="mix_ka", mesh_shader=FROM_SELECTION1,
                            shadows=False, traversal="bsp"),
                model=f"{REF_RES}/models/{model}"))
    add(_mk("W6 E2 Cornell Box", "w6e2.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_MESH_DIRECT, lights=("area_all",), ambient="plain",
                        traversal="bsp", use_vertex_normals=False),
            model=f"{REF_RES}/models/CornellBoxWithBlocks.obj"))
    add(_mk("W6 E3 Cornell Box", "w6e3.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_MESH_DIRECT, eta=1e-3, bg_color=(0.0, 0.0, 0.0),
                        lights=("area_all",), ambient="plain",
                        traversal="bsp", use_vertex_normals=False),
            model=f"{REF_RES}/models/CornellBox.obj",
            analytics=dict(spheres=[
                ((420.0, 90.0, 370.0), 90.0, 2, (0.0, 0.0, 0.0), 1.5, (0.0, 0.0, 0.0)),
                ((130.0, 90.0, 250.0), 90.0, 4, (0.0, 0.0, 0.0), 1.5, (0.0, 0.0, 0.0)),
            ])))

    # --- Worksheet 7 (progressive path tracing in the Cornell box).
    add(_mk("W7 E1 Cornell Box", "w7e1.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_MESH_DIRECT, eta=1e-3, bg_color=(0.0, 0.0, 0.0),
                        lights=("area_all",), ambient="plain", traversal="bsp",
                        progressive=True, use_vertex_normals=False),
            model=f"{REF_RES}/models/CornellBoxWithBlocks.obj"))
    add(_mk("W7 E2 Cornell Box", "w7e2.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_MESH_DIRECT, eta=1e-3, bg_color=(0.0, 0.0, 0.0),
                        lights=("area_all",), ambient="plain", traversal="bsp",
                        progressive=True, use_vertex_normals=False),
            model=f"{REF_RES}/models/CornellBoxWithBlocks.obj"))
    add(_mk("W7 E3 Cornell Box", "w7e3.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_CORNELL_PATH, max_depth=50, eta=1e-2,
                        emission_factor=False, traversal="bsp"),
            model=f"{REF_RES}/models/CornellBoxWithBlocks.obj"))

    # --- Worksheet 8 (specular path tracing, Fresnel, absorption).
    add(_mk("W8 E1 Cornell Box Balls", "w8e1.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_CORNELL_PATH, max_depth=10, bg_color=(0.1, 0.3, 0.6),
                        rr=False, diffuse_factor=False, emission_factor=False,
                        dielectric="simple", traversal="bsp"),
            model=f"{REF_RES}/models/CornellBox.obj",
            analytics=_cornell_balls(7)))
    add(_mk("W8 E2 Cornell Box Balls", "w8e2.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_CORNELL_PATH, max_depth=50, dielectric="fresnel",
                        traversal="bsp"),
            model=f"{REF_RES}/models/CornellBox.obj",
            analytics=_cornell_balls(7)))
    add(_mk("W8 E3 Absorption", "w8e3.wgsl", CORNELL_CAM, (512, 512),
            cfg_kw=dict(_CORNELL_PATH, max_depth=10, dielectric="absorb",
                        firefly_clamp=100.0, traversal="bsp"),
            model=f"{REF_RES}/models/CornellBox.obj",
            analytics=_cornell_balls(7)))

    # --- Worksheet 9 (environment maps).
    for nm, model, cam, res in (
        ("W9 E1 Teapot", "teapot.obj", TEAPOT_CAM, (800, 450)),
        ("W9 E1 Bunny", "bunny.obj", BUNNY_CAM, (512, 512)),
    ):
        add(_mk(nm, "w9e1.wgsl", cam, res,
                cfg_kw=dict(mode="path", max_depth=50, eta=1e-4,
                            bg_color=(0.0, 0.0, 0.0), gamma=1.5,
                            lights=("none",), env_light=True,
                            mesh_shader=FROM_SELECTION1, traversal="bsp",
                            progressive=True),
                model=f"{REF_RES}/models/{model}",
                hdri=f"{REF_RES}/textures/luxo_pxr_campus.jpg"))
    for nm, model, cam, res in (
        ("W9 E2 Teapot", "teapot.obj", TEAPOT_CAM, (800, 450)),
        ("W9 E2 Bunny", "bunny.obj", BUNNY_CAM, (512, 512)),
    ):
        add(_mk(nm, "w9e2.wgsl", cam, res,
                cfg_kw=dict(mode="path", max_depth=50, eta=1e-4,
                            bg_color=(0.0, 0.0, 0.0), gamma=1.0,
                            lights=("none",), env_light=True,
                            mesh_shader=FROM_SELECTION1, traversal="bsp",
                            progressive=True),
                model=f"{REF_RES}/models/{model}",
                hdri=f"{REF_RES}/textures/luxo_pxr_campus.hdr.png",
                hdri_rgbe=True,
                analytics=dict(planes=[(
                    _PLANE_ONB["position"], (0.0, 1.0, 0.0),
                    (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                    8, (0.0, 0.0, 0.0), False,
                )])))
    add(_mk("W9 E3 Teapot", "w9e3.wgsl", TEAPOT_CAM, (800, 450),
            cfg_kw=dict(mode="path", max_depth=50, eta=1e-4,
                        bg_color=(0.0, 0.0, 0.0), gamma=1.5,
                        lights=("directional",),
                        dir_light_direction=(-1.0, -1.0, -1.0),
                        dir_light_intensity=(10.0, 10.0, 10.0),
                        env_light=True, mesh_shader=FROM_SELECTION1,
                        traversal="bsp", progressive=True),
            model=f"{REF_RES}/models/teapot.obj",
            hdri=f"{REF_RES}/textures/luxo_pxr_campus.jpg",
            analytics=dict(planes=[(
                _PLANE_ONB["position"], (0.0, 1.0, 0.0),
                (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                8, (0.0, 0.0, 0.0), False,
            )])))

    # --- Project benchmark scenes (project.wgsl; BVH vs BSP).
    for nm, model, cam, res, trav in (
        ("Project: Quad", "plane.obj", BASIC_CAM, (512, 512), "bvh"),
        ("Project: Three Quads", "test_object.obj", BASIC_CAM, (512, 512), "bvh"),
        ("Project: Cornell Box", "CornellBoxWithBlocks.obj", CORNELL_CAM, (512, 512), "bvh"),
        ("Project: Utah Teapot", "teapot.obj", TEAPOT_CAM, (800, 450), "bvh"),
        ("Project: Utah Teapot BSP", "teapot.obj", TEAPOT_CAM, (800, 450), "bsp"),
        ("Project: Bunny", "bunny.obj", BUNNY_CAM, (512, 512), "bvh"),
        ("Project: Bunny BSP", "bunny.obj", BUNNY_CAM, (512, 512), "bsp"),
        ("Project: Dragon", "dragon.obj", DRAGON_CAM, (800, 450), "bvh"),
        ("Project: Dragon BSP", "dragon.obj", DRAGON_CAM, (800, 450), "bsp"),
    ):
        add(_mk(nm, "project.wgsl", cam, res,
                cfg_kw=dict(mode="direct", max_depth=10, eta=1e-5,
                            bg_color=(0.1, 0.3, 0.6), gamma=1.5,
                            lights=("directional_n",), shadows=False,
                            ambient="plain_scaled",
                            mesh_shader=FROM_SELECTION1,
                            traversal=trav, use_vertex_normals=True),
                model=f"{REF_RES}/models/{model}"))
    return s


_BY_NAME = None


def get_scene(name: str) -> SceneDescriptor:
    global _BY_NAME
    if _BY_NAME is None:
        _BY_NAME = {d.name: d for d in get_scenes()}
    return _BY_NAME[name]

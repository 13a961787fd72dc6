"""Carry a scene built elsewhere into the port, buffer for buffer.

``scene_from_arrays`` reads any object with the attribute names of the JAX
package's ``Scene`` whose leaves are NumPy arrays (for example
``jax.tree.map(np.asarray, scene)``) and returns the port's ``Scene`` on
``device``, analytic spheres, planes and triangles, the environment map,
the plane texture, the stratified jitters and the structures of the
``bvh2`` and BSP walks included (no mesh for a meshless scene, and no
treelet BVH for a mesh on the brute-force engine), so both
implementations can be run on the very same buffers.
``grads_to_arrays`` reads a scene gradient of either package the same way,
so the two can be compared leaf by leaf. Both only read attributes and
import nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_torch.accel import bsp as bsp_mod
from tracer_torch.accel import traverse
from tracer_torch.accel.treelet import TreeletBvh, quarter_normals
from tracer_torch.diff.grad import FLOAT_LEAVES, leaf
from tracer_torch.geometry.device import (AnalyticTriangles, GeometryBuffers, MaterialTable,
                                         Planes)
from tracer_torch.render.camera import Camera
from tracer_torch.render.scene import Scene, Spheres, Uniforms
from tracer_torch.render.texture import TextureBuf


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def treelet_from_arrays(tb, device) -> TreeletBvh:
    """The quarter blocks, quarter boxes, treelet boxes and top tree of a
    treelet BVH whose leaves are arrays, and the quarters' normal data
    derived from the blocks as the port's builder derives it."""
    qblocks = _t(tb.qblocks, device)
    return TreeletBvh(
        qblocks=qblocks,
        qbox=_t(tb.qbox, device),
        qnorm=quarter_normals(qblocks),
        t_lo=_t(tb.t_lo, device),
        t_hi=_t(tb.t_hi, device),
        top=_t(tb.top, device),
        T=int(tb.T),
        depth=int(tb.depth),
    )


def grads_to_arrays(g) -> dict:
    """The float leaves of a scene gradient as NumPy arrays, keyed by their
    path in the JAX package's ``Scene`` pytree (``"camera.eye"``,
    ``"geom.vertices"``, ``"spheres.center"``, ``"env.data"``, ...). Reads
    any object with those attributes whose leaves are tensors or arrays:
    the port's ``grad_scene`` result or the JAX package's. Parts that are
    ``None`` (a scene without spheres, planes or environment map in the
    port, no environment map in the JAX package) give no keys."""
    out = {}
    for key in FLOAT_LEAVES:
        x = leaf(g, key)
        if x is not None:
            out[key] = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return out


def _texture(t, device):
    return None if t is None else TextureBuf(data=_t(t.data, device), kind=int(t.kind))


def scene_from_arrays(obj, device) -> Scene:
    cam, uni, g, m, p, sp, tr = (obj.camera, obj.uniforms, obj.geom, obj.materials, obj.planes,
                                 obj.spheres, obj.tris)
    i32 = torch.int32
    spheres = planes = tris = None
    if np.asarray(sp.radius).shape[0]:
        spheres = Spheres(
            center=_t(sp.center, device), radius=_t(sp.radius, device),
            shader=_t(sp.shader, device, i32), base_color=_t(sp.base_color, device),
            ior=_t(sp.ior, device), extinction=_t(sp.extinction, device),
        )
    if np.asarray(p.normal).shape[0]:
        planes = Planes(
            position=_t(p.position, device), normal=_t(p.normal, device),
            tangent=_t(p.tangent, device), binormal=_t(p.binormal, device),
            shader=_t(p.shader, device, i32), base_color=_t(p.base_color, device),
            textured=_t(p.textured, device, i32),
        )
    if np.asarray(tr.shader).shape[0]:
        tris = AnalyticTriangles(verts=_t(tr.verts, device), shader=_t(tr.shader, device, i32),
                                 base_color=_t(tr.base_color, device))
    geom = materials = light_indices = None
    if g is not None:
        geom = GeometryBuffers(
            vertices=_t(g.vertices, device), normals=_t(g.normals, device),
            indices=_t(g.indices, device, i32), mat_ids=_t(g.mat_ids, device, i32),
            tri_table=_t(g.tri_table, device),
        )
        materials = MaterialTable(
            diffuse=_t(m.diffuse, device), emission=_t(m.emission, device),
            specular=_t(m.specular, device), illum=_t(m.illum, device, i32),
            shininess=_t(m.shininess, device), ior=_t(m.ior, device),
        )
        light_indices = _t(obj.light_indices, device, i32)
    return Scene(
        camera=Camera(
            eye=_t(cam.eye, device), target=_t(cam.target, device),
            up=_t(cam.up, device), constant=_t(cam.constant, device),
            aspect=_t(cam.aspect, device),
        ),
        uniforms=Uniforms(
            selection1=int(uni.selection1),
            selection2=int(uni.selection2),
            use_texture=int(uni.use_texture),
            uv_scale=_t(uni.uv_scale, device),
            iteration=int(uni.iteration),
        ),
        geom=geom,
        materials=materials,
        light_indices=light_indices,
        tb=None if obj.tb is None else treelet_from_arrays(obj.tb, device),
        bvh=None if obj.bvh is None else traverse.to_device(obj.bvh, device),
        bsp=None if obj.bsp is None else bsp_mod.to_device(obj.bsp, device),
        planes=planes,
        env=_texture(obj.env, device),
        spheres=spheres,
        tris=tris,
        texture=_texture(obj.texture, device),
        jitters=None if obj.jitters is None else _t(obj.jitters, device),
    )

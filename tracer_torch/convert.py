"""Carry a scene built elsewhere into the port, buffer for buffer.

``scene_from_arrays`` reads any object with the attribute names of the JAX
package's ``Scene`` whose leaves are NumPy arrays (for example
``jax.tree.map(np.asarray, scene)``) and returns the port's ``Scene`` on
``device``, analytic planes and environment map included, so both
implementations can be run on the very same buffers.
``grads_to_arrays`` reads a scene gradient of either package the same way,
so the two can be compared leaf by leaf. Both only read attributes and
import nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tracer_torch.accel.treelet import TreeletBvh
from tracer_torch.diff.grad import FLOAT_LEAVES, leaf
from tracer_torch.geometry.device import GeometryBuffers, MaterialTable, Planes
from tracer_torch.render.camera import Camera
from tracer_torch.render.scene import Scene, Uniforms
from tracer_torch.render.texture import TextureBuf


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def treelet_from_arrays(tb, device) -> TreeletBvh:
    """The quarter blocks, quarter boxes, treelet boxes and top tree of a
    treelet BVH whose leaves are arrays."""
    return TreeletBvh(
        qblocks=_t(tb.qblocks, device),
        qbox=_t(tb.qbox, device),
        t_lo=_t(tb.t_lo, device),
        t_hi=_t(tb.t_hi, device),
        top=_t(tb.top, device),
        T=int(tb.T),
        depth=int(tb.depth),
    )


def grads_to_arrays(g) -> dict:
    """The float leaves of a scene gradient as NumPy arrays, keyed by their
    path in the JAX package's ``Scene`` pytree (``"camera.eye"``,
    ``"geom.vertices"``, ...). Reads any object with those attributes whose
    leaves are tensors or arrays: the port's ``grad_scene`` result or the
    JAX package's."""
    out = {}
    for key in FLOAT_LEAVES:
        x = leaf(g, key)
        out[key] = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return out


def scene_from_arrays(obj, device) -> Scene:
    for kind, rows in (("spheres", obj.spheres.radius), ("triangles", obj.tris.shader)):
        if np.asarray(rows).shape[0]:
            raise NotImplementedError(f"analytic {kind} are not ported")
    if obj.geom is None or obj.tb is None:
        raise NotImplementedError("only mesh scenes on the treelet engine are ported")
    cam, uni, g, m, p = obj.camera, obj.uniforms, obj.geom, obj.materials, obj.planes
    i32 = torch.int32
    planes = None
    if np.asarray(p.normal).shape[0]:
        planes = Planes(
            position=_t(p.position, device), normal=_t(p.normal, device),
            tangent=_t(p.tangent, device), binormal=_t(p.binormal, device),
            shader=_t(p.shader, device, i32), base_color=_t(p.base_color, device),
            textured=_t(p.textured, device, i32),
        )
    env = None if obj.env is None else TextureBuf(
        data=_t(obj.env.data, device), kind=int(obj.env.kind))
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
            uv_scale=tuple(float(x) for x in np.asarray(uni.uv_scale)),
            iteration=int(uni.iteration),
        ),
        geom=GeometryBuffers(
            vertices=_t(g.vertices, device), normals=_t(g.normals, device),
            indices=_t(g.indices, device, i32), mat_ids=_t(g.mat_ids, device, i32),
            tri_table=_t(g.tri_table, device),
        ),
        materials=MaterialTable(
            diffuse=_t(m.diffuse, device), emission=_t(m.emission, device),
            specular=_t(m.specular, device), illum=_t(m.illum, device, i32),
            shininess=_t(m.shininess, device), ior=_t(m.ior, device),
        ),
        light_indices=_t(obj.light_indices, device, i32),
        tb=treelet_from_arrays(obj.tb, device),
        planes=planes,
        env=env,
    )

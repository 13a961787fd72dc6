"""Device-resident mesh buffers (port of ``tracer.geometry.device``).

Hit attributes are fetched with one row gather from the per-triangle table
(``fetch_tri_rows``), whose backward places the corner cotangents into the
canonical vertex and normal buffers through the ``scatter_vn`` kernel. The
JAX package's scatter modes and its TPU-link upload packing are TPU and
sharding workarounds and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from tracer_torch.geometry.obj import MeshData
from tracer_torch.kernels.scatter_vn import scatter_add_vn

# Shader ids — exact parity with the reference's WGSL constants
# (e.g. w9e2.wgsl:7-15) and the UI enum (command.rs:39-47).
SHADER_LAMBERTIAN = 0
SHADER_PHONG = 1
SHADER_MIRROR = 2
SHADER_TRANSMIT = 3
SHADER_GLOSSY = 4
SHADER_NORMAL = 5
SHADER_BASECOLOR = 6
SHADER_TRANSPARENT = 7  # Fresnel-weighted reflect/refract (+Beer-Lambert)
SHADER_HOLDOUT = 8
SHADER_NO_RENDER = 255

TRI_COLS = 20  # (T, 20): 9 vertex + 9 normal + 1 mat id + 1 pad


@dataclass(frozen=True)
class GeometryBuffers:
    """Triangle mesh SoA on the device."""

    vertices: torch.Tensor  # (V, 3) f32
    normals: torch.Tensor  # (V, 3) f32
    indices: torch.Tensor  # (T, 3) i32
    mat_ids: torch.Tensor  # (T,) i32
    # Per-triangle attribute rows: [0:3] v0 [3:6] v1 [6:9] v2 [9:12] n0
    # [12:15] n1 [15:18] n2 [18] mat id (exact f32) [19] pad.
    tri_table: torch.Tensor  # (T, 20) f32


@dataclass(frozen=True)
class MaterialTable:
    """Material SoA (``reference/src/mesh.rs:12-31``); ``emission`` is the
    MTL ``Ka`` channel, ``illum`` the raw illumination-model id."""

    diffuse: torch.Tensor  # (M, 3) f32
    emission: torch.Tensor  # (M, 3) f32
    specular: torch.Tensor  # (M, 3) f32
    illum: torch.Tensor  # (M,) i32
    shininess: torch.Tensor  # (M,) f32
    ior: torch.Tensor  # (M,) f32


@dataclass(frozen=True)
class Planes:
    """Analytic planes with a basis for texturing (``w9e2.wgsl:383-404``)."""

    position: torch.Tensor  # (P, 3) f32
    normal: torch.Tensor  # (P, 3) f32
    tangent: torch.Tensor  # (P, 3) f32
    binormal: torch.Tensor  # (P, 3) f32
    shader: torch.Tensor  # (P,) i32
    base_color: torch.Tensor  # (P, 3) f32
    textured: torch.Tensor  # (P,) i32: sample the bound texture for albedo


def _tri_table(verts, norms, idx, mat_ids):
    """Per-triangle attribute rows gathered on the device: v0 v1 v2 (9),
    n0 n1 n2 (9), mat id (1), padding to TRI_COLS."""
    idx = idx.long()
    cols = [verts[idx[:, c]] for c in range(3)]
    cols += [norms[idx[:, c]] for c in range(3)]
    cols.append(mat_ids.to(torch.float32)[:, None])
    cols.append(torch.zeros((idx.shape[0], TRI_COLS - 19), dtype=torch.float32,
                            device=verts.device))
    return torch.cat(cols, dim=1)


def refresh_tri_table(geom: GeometryBuffers) -> GeometryBuffers:
    """Rebuild the derived (T, 20) attribute table after the vertices or
    normals changed (an optimisation step or an FD probe). The table is a
    cache of the canonical buffers and carries no gradient: gradients reach
    the vertices and normals through ``fetch_tri_rows``."""
    table = _tri_table(geom.vertices.detach(), geom.normals.detach(),
                       geom.indices, geom.mat_ids)
    return replace(geom, tri_table=table)


def _corner_cotangents(g):
    """(N, 20) row cotangent -> (N, 3, 6) per-corner [vertex xyz, normal xyz]."""
    n = g.shape[0]
    gv = g[:, 0:9].reshape(n, 3, 3)
    gn = g[:, 9:18].reshape(n, 3, 3)
    return torch.cat([gv, gn], dim=-1)


def _scatter_add_vn(idx_n, gvn, V: int):
    """(N, 3) corner ids + (N, 3, 6) cotangents -> (V, 6) sums."""
    return scatter_add_vn(idx_n.reshape(-1), gvn.reshape(-1, 6), V)


class _FetchTriRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, normals, tri_table, idx, tri_c):
        ctx.save_for_backward(idx, tri_c)
        ctx.n_vertices = vertices.shape[0]
        return tri_table[tri_c]

    @staticmethod
    def backward(ctx, g):
        idx, tri_c = ctx.saved_tensors
        dvn = _scatter_add_vn(idx[tri_c], _corner_cotangents(g), ctx.n_vertices)
        return dvn[:, 0:3], dvn[:, 3:6], None, None, None


def fetch_tri_rows(vertices, normals, tri_table, idx, tri_c):
    """Differentiable per-hit attribute fetch: ``tri_table[tri_c]`` forward,
    one stacked (V, 6) placement of the corner cotangents backward.

    Contract (as in the JAX package): ``tri_table`` is consistent with
    ``vertices``/``normals`` (``refresh_tri_table`` after changing them);
    gradients flow to the vertices and normals, and the table, ``idx`` and
    ``tri_c`` get none.
    """
    return _FetchTriRows.apply(vertices, normals, tri_table, idx, tri_c)


def upload_mesh(mesh: MeshData, device) -> tuple[GeometryBuffers, MaterialTable, torch.Tensor]:
    """MeshData -> (geometry, materials, light_indices) on ``device``.

    Material ids of ``u32::MAX`` (no material) map to material 0, and the
    light list holds exactly the emissive-triangle ids.
    """
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    mats = mesh.materials
    verts = f32(mesh.vertices)
    norms = f32(mesh.normals)
    idx = i32(mesh.indices.astype(np.int32))
    mat = i32(np.where(mesh.mat_ids == 0xFFFFFFFF, 0, mesh.mat_ids))
    geom = GeometryBuffers(
        vertices=verts, normals=norms, indices=idx, mat_ids=mat,
        tri_table=_tri_table(verts, norms, idx, mat),
    )
    table = MaterialTable(
        diffuse=f32(np.stack([m.diffuse for m in mats])),
        emission=f32(np.stack([m.ambient for m in mats])),
        specular=f32(np.stack([m.specular for m in mats])),
        illum=i32([m.illum for m in mats]),
        shininess=f32([m.shininess for m in mats]),
        ior=f32([m.ior for m in mats]),
    )
    lights = i32(mesh.light_indices().astype(np.int32))
    return geom, table, lights

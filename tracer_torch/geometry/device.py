"""Device-resident mesh buffers (port of ``tracer.geometry.device``).

The forward path fetches hit attributes with one row gather from the
per-triangle table. The JAX package's differentiable fetch
(``fetch_tri_rows`` and its custom VJP) and its TPU-link upload packing are
not part of this port yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tracer_torch.geometry.obj import MeshData

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

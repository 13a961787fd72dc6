"""The Wavefront OBJ/MTL parse, frozen.

A copy of ``load_mtl`` and ``load_obj`` from
``tracer_torch/geometry/obj.py`` as of commit 1568230 (NumPy, the same
operations in the same order), so the benchmark parses a configuration's
model file itself, checks the program's mesh against its parse and hands
the parse to its reference without importing the program. Faces of no
material take material 0 and are never lights, as the program's upload
makes them (``geometry/device.upload_mesh``, ``MeshData.light_indices``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

NO_MATERIAL = 0xFFFFFFFF


class Mesh(NamedTuple):
    """What a reference module receives for a configuration on a model
    file: the parse's vertices (V, 3) f32, normals (V, 3) f32 (zeros where
    the file has none) and indices (T, 3) u32; each face's diffuse colour
    ``kd`` (T, 3) f32 (MTL ``Kd``), emitted radiance ``emission`` (T, 3)
    f32 (MTL ``Ka``) and ``light`` flag (T,) bool (MTL ``illum 1``); and
    the configuration's analytic primitives in the registry's tuple
    layout, as JSON states them (the harness fills them in). ``mesh[:3]``
    is the (V, Nv, I) that a stand-in configuration's reference receives."""

    V: np.ndarray
    Nv: np.ndarray
    I: np.ndarray
    kd: np.ndarray
    emission: np.ndarray
    light: np.ndarray
    spheres: tuple = ()
    planes: tuple = ()
    tris: tuple = ()


def _material(diffuse=(1.0, 1.0, 1.0)) -> dict:
    return dict(diffuse=np.array(diffuse, np.float32), ambient=np.zeros(3, np.float32), illum=0)


def _parse_floats(parts: list, n: int) -> list:
    vals = [float(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return vals


def load_mtl(path) -> dict:
    """The named materials of an MTL file: of each, what the benchmark
    reads (``Kd``, ``Ka``, ``illum``)."""
    materials: dict = {}
    cur = None
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                name = parts[1] if len(parts) > 1 else ""
                cur = _material()
                materials[name] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur["diffuse"] = np.array(_parse_floats(parts[1:], 3), np.float32)
            elif key == "Ka":
                cur["ambient"] = np.array(_parse_floats(parts[1:], 3), np.float32)
            elif key == "illum":
                cur["illum"] = int(float(parts[1]))
    return materials


def load_obj(path):
    """(vertices, normals, indices, mat_ids, materials) of an OBJ and its
    MTL: one output vertex per distinct ``v/vt/vn`` corner in first-use
    order (the corner cache reset at each ``o``/``g``), polygons
    fan-triangulated, ``mat_ids`` ``NO_MATERIAL`` where no known material
    is in use, all normals zero unless every vertex has one."""
    positions: list = []
    normals_in: list = []
    texcoords: list = []
    mtl: dict = {}
    mat_order: list = []
    out_vertices: list = []
    out_normals: list = []
    out_indices: list = []
    out_matids: list = []
    corner_cache: dict = {}
    cur_material = -1

    def corner_index(spec: str) -> int:
        toks = spec.split("/")
        vi = int(toks[0])
        ti = int(toks[1]) if len(toks) > 1 and toks[1] else 0
        ni = int(toks[2]) if len(toks) > 2 and toks[2] else 0
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ti - 1 if ti > 0 else (len(texcoords) + ti if ti < 0 else -1)
        ni = ni - 1 if ni > 0 else (len(normals_in) + ni if ni < 0 else -1)
        key = (vi, ti, ni)
        idx = corner_cache.get(key)
        if idx is None:
            idx = len(out_vertices)
            corner_cache[key] = idx
            out_vertices.append(positions[vi])
            out_normals.append(normals_in[ni] if ni >= 0 else None)
        return idx

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append(_parse_floats(parts[1:], 3))
            elif key == "vn":
                normals_in.append(_parse_floats(parts[1:], 3))
            elif key == "vt":
                texcoords.append(_parse_floats(parts[1:], 2))
            elif key == "f":
                corners = [corner_index(p) for p in parts[1:]]
                for k in range(1, len(corners) - 1):
                    out_indices.append((corners[0], corners[k], corners[k + 1]))
                    out_matids.append(cur_material)
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                cur_material = mat_order.index(name) if name in mtl else -1
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    for name, m in load_mtl(mtl_path).items():
                        if name not in mtl:
                            mat_order.append(name)
                        mtl[name] = m
            elif key in ("o", "g"):
                corner_cache.clear()

    num_v = len(out_vertices)
    vertices = np.asarray(out_vertices, np.float32).reshape(num_v, 3)
    if num_v and all(n is not None for n in out_normals):
        normals = np.asarray(out_normals, np.float32).reshape(num_v, 3)
    else:
        normals = np.zeros((num_v, 3), np.float32)
        for i, n in enumerate(out_normals):
            if n is not None:
                normals[i] = n
    indices = np.asarray(out_indices, np.uint32).reshape(-1, 3)
    mat_ids = np.asarray([m if m >= 0 else NO_MATERIAL for m in out_matids], np.uint32)
    materials = [mtl[name] for name in mat_order] or [_material(diffuse=(0.5, 0.5, 0.5))]
    return vertices, normals, indices, mat_ids, materials


def load(path, scale: float = 1.0) -> Mesh:
    """The configuration's model file as the benchmark's ``Mesh``: the
    vertices scaled by ``scale`` (in float32, where it is not 1), each
    face's material."""
    V, Nv, I, mat_ids, materials = load_obj(path)
    if scale != 1.0:
        V = V * np.float32(scale)
    mat = np.where(mat_ids == NO_MATERIAL, 0, mat_ids).astype(np.int64)
    kd = np.stack([m["diffuse"] for m in materials])[mat]
    emission = np.stack([m["ambient"] for m in materials])[mat]
    illum = np.array([m["illum"] for m in materials] + [0], np.int64)
    light = illum[np.minimum(mat_ids.astype(np.int64), len(materials))] == 1
    return Mesh(V, Nv, I, kd, emission, light)

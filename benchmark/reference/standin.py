"""The procedural stand-in meshes, frozen.

A copy of ``uv_sphere`` and ``bumpy_blob`` from
``tracer_torch/geometry/procedural.py`` as of commit 571a042 (NumPy, the
same operations in the same order), so the benchmark makes the mesh it
checks the program against and hands to its reference without importing
the program. A configuration's ``standin`` entry gives the arguments,
and ``flip_normals`` where the benchmark turns the normals outward (the
generator's point into the mesh; the harness turns the program's the
same way).
"""

from __future__ import annotations

import numpy as np


def uv_sphere(n_lat: int, n_lon: int, radius: float, center):
    """(vertices (V, 3) f32, normals (V, 3) f32, indices (T, 3) u32) of a
    lat-long sphere: 2 * n_lat * n_lon - 2 * n_lon triangles."""
    lat = np.linspace(0.0, np.pi, n_lat + 1, dtype=np.float32)
    lon = np.linspace(0.0, 2 * np.pi, n_lon + 1, dtype=np.float32)[:-1]
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    pts = np.empty(((n_lat + 1) * n_lon, 3), np.float32)
    np.outer(sin_lat, cos_lon, out=pts[:, 0].reshape(n_lat + 1, n_lon))
    pts[:, 1] = np.repeat(cos_lat, n_lon)
    np.outer(sin_lat, sin_lon, out=pts[:, 2].reshape(n_lat + 1, n_lon))
    ii = np.arange(n_lat, dtype=np.int32)[:, None]
    jj = np.arange(n_lon, dtype=np.int32)[None, :]
    jn = np.roll(np.arange(n_lon, dtype=np.int32), -1)[None, :]
    a = ii * n_lon + jj
    b = ii * n_lon + jn
    c = a + n_lon
    d = b + n_lon
    pair = np.empty((n_lat, n_lon, 2, 3), np.int32)
    pair[:, :, 0, 0] = a
    pair[:, :, 0, 1] = c
    pair[:, :, 0, 2] = b
    pair[:, :, 1, 0] = b
    pair[:, :, 1, 1] = c
    pair[:, :, 1, 2] = d
    valid = np.empty((n_lat, n_lon, 2), bool)
    valid[:, :, 0] = ii > 0
    valid[:, :, 1] = ii < n_lat - 1
    faces = pair.reshape(-1, 3)[valid.reshape(-1)]
    verts = pts * np.float32(radius) + np.asarray(center, np.float32)
    return verts, pts, faces.view(np.uint32)


def bumpy_blob(n_lat: int, n_lon: int, radius: float, center, seed: int = 0):
    """(vertices, normals, indices) of a sphere perturbed by five seeded
    low-frequency bumps, with area-weighted vertex normals from the faces."""
    v, _, indices = uv_sphere(n_lat, n_lon, 1.0, (0.0, 0.0, 0.0))
    rs = np.random.RandomState(seed)
    freqs = rs.randn(5, 3).astype(np.float32)
    phase = rs.rand(5).astype(np.float32) * 6.28
    bump = np.zeros(v.shape[0], np.float32)
    for k in range(5):
        bump += 0.08 * np.sin(v @ (freqs[k] * 3.0) + phase[k])
    scale = (1.0 + bump)[:, None]
    verts = (v * scale * radius + np.asarray(center)).astype(np.float32)
    idx = indices.astype(np.int64)
    a, b, c = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    fn = np.cross(b - a, c - a)
    normals = np.zeros_like(verts)
    nv = verts.shape[0]
    for k in range(3):
        for comp in range(3):
            normals[:, comp] += np.bincount(
                idx[:, k], weights=fn[:, comp], minlength=nv
            ).astype(np.float32)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = (normals / np.maximum(lens, 1e-20)).astype(np.float32)
    return verts, normals, indices


def make(params: dict):
    """The stand-in a configuration's ``standin`` entry names."""
    verts, normals, indices = bumpy_blob(params["n_lat"], params["n_lon"], params["radius"],
                                         tuple(params["center"]), seed=params["seed"])
    return verts, (-normals if params.get("flip_normals") else normals), indices

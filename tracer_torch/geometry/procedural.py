"""Procedural stand-in meshes (port of ``tracer.geometry.procedural``).

NumPy host code, kept bit-identical to the JAX package's generators.

``res/models/bunny.obj`` and ``res/models/dragon.obj`` appear in the scene
table (``reference/src/scenes.rs:91-93``) but are listed in
``.MISSING_LARGE_BLOBS``. These generators produce meshes of comparable
triangle count and world placement (bunny ~69k tris around the bunny camera
target, dragon ~871k) so the scenes render and benchmarks measure realistic
workloads. They are clearly stand-ins, not the Stanford models.
"""

from __future__ import annotations

import numpy as np

from tracer_torch.geometry.obj import MaterialData, MeshData

# Bump when any stand-in generator's output changes: the disk mesh cache
# keys on this (tracer_torch.scenes.cache._mesh_key) to invalidate stale
# entries.
STANDIN_V = 1


def uv_sphere(n_lat: int, n_lon: int, radius: float, center) -> MeshData:
    """Lat-long sphere with smooth normals; 2 * n_lat * n_lon triangles."""
    # 1D trig + outer products (the 2D grid is rank-1 in lat/lon).
    lat = np.linspace(0.0, np.pi, n_lat + 1, dtype=np.float32)
    lon = np.linspace(0.0, 2 * np.pi, n_lon + 1, dtype=np.float32)[:-1]
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    pts = np.empty(((n_lat + 1) * n_lon, 3), np.float32)
    np.outer(sin_lat, cos_lon, out=pts[:, 0].reshape(n_lat + 1, n_lon))
    pts[:, 1] = np.repeat(cos_lat, n_lon)
    np.outer(sin_lat, sin_lon, out=pts[:, 2].reshape(n_lat + 1, n_lon))

    # Vectorized face table, emitted in the exact (i, j, [top, bottom])
    # order of the original scalar loops (dragon stand-in = 871k faces;
    # Python-loop generation was seconds of interpreter time, VERDICT r1).
    ii = np.arange(n_lat, dtype=np.int32)[:, None]
    jj = np.arange(n_lon, dtype=np.int32)[None, :]
    jn = np.roll(np.arange(n_lon, dtype=np.int32), -1)[None, :]  # (j+1)%n
    a = ii * n_lon + jj
    b = ii * n_lon + jn
    c = a + n_lon
    d = b + n_lon
    # (n_lat, n_lon, 2, 3): [top=(a,c,b), bottom=(b,c,d)] per cell, flattened
    # in the same (i, j, [top, bottom]) order as the original scalar loop.
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
    normals = pts
    idx = faces.view(np.uint32)
    return MeshData(
        vertices=verts,
        normals=normals,
        indices=idx,
        mat_ids=np.zeros(idx.shape[0], np.uint32),
        materials=[MaterialData.default()],
    )


def bumpy_blob(n_lat: int, n_lon: int, radius: float, center, seed=0) -> MeshData:
    """Sphere perturbed by low-frequency bumps — a stand-in with non-trivial
    normal variation and BVH structure."""
    m = uv_sphere(n_lat, n_lon, 1.0, (0.0, 0.0, 0.0))
    v = m.vertices
    rs = np.random.RandomState(seed)
    freqs = rs.randn(5, 3).astype(np.float32)
    phase = rs.rand(5).astype(np.float32) * 6.28
    bump = np.zeros(v.shape[0], np.float32)
    for k in range(5):
        bump += 0.08 * np.sin(v @ (freqs[k] * 3.0) + phase[k])
    scale = (1.0 + bump)[:, None]
    verts = (v * scale * radius + np.asarray(center)).astype(np.float32)
    # Recompute smooth-ish normals from faces.
    idx = m.indices.astype(np.int64)
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
    return MeshData(
        vertices=verts,
        normals=normals,
        indices=m.indices,
        mat_ids=m.mat_ids,
        materials=m.materials,
    )


def standin_for(path: str) -> MeshData:
    """Stand-in selection by missing-asset name."""
    name = path.rsplit("/", 1)[-1]
    if "bunny" in name:
        # bunny: 69,451 tris, fits the bunny camera (target ~(-0.02, 0.11, 0))
        return bumpy_blob(187, 187, 0.09, (-0.02, 0.11, 0.0), seed=1)
    if "dragon" in name:
        # dragon: 871,414 tris
        return bumpy_blob(660, 660, 0.10, (-0.02, 0.11, 0.0), seed=2)
    raise FileNotFoundError(path)

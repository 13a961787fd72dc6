"""Disk cache of scene-build products: the mesh and the host half of the
treelet build (port of ``tracer.scenes.cache``).

The host half of a build (OBJ parse or procedural generation, LBVH, treelet
cut) costs seconds of CPU for the large stand-ins, so warm builds read it
from disk:

* mesh entries key on (path, scale, mtime), or on the generator version
  for the procedural stand-ins, and store the SoA arrays and the material
  table;
* treelet entries key on the mesh's content fingerprint and the build
  parameters and store the ``TreeletHost``; the block table is gathered on
  the device from it (``tracer_torch.accel.treelet.from_host``).

``TRACER_SCENE_CACHE`` relocates the cache and ``TRACER_NO_SCENE_CACHE=1``
turns it off, as in the JAX package; by default it lies in the checkout,
under ``build/tracer_torch/scene-cache``. Entries are written to a
temporary file and renamed, and their names carry a ``torch-`` prefix, so
neither package reads the other's. An entry that cannot be read is a miss:
the caller rebuilds.
"""

from __future__ import annotations

import hashlib
import os
import zipfile

import numpy as np

from tracer_torch._build import BUILD_DIR

PREFIX = "torch-"
DEFAULT_DIR = BUILD_DIR / "scene-cache"


def _cache_dir() -> str | None:
    if os.environ.get("TRACER_NO_SCENE_CACHE"):
        return None
    d = os.environ.get("TRACER_SCENE_CACHE", str(DEFAULT_DIR))
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def _atomic_savez(path: str, **arrays) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _read(path: str) -> dict | None:
    """Every array of the entry at ``path``; None when it is missing or
    cannot be read (truncated, corrupt)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def mesh_fingerprint(mesh) -> str:
    """Content hash of the geometry that determines the acceleration
    structure."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mesh.vertices).tobytes())
    h.update(np.ascontiguousarray(mesh.indices).tobytes())
    return h.hexdigest()


# --- Mesh cache -------------------------------------------------------------

_MESH_V = "m1"


def _mesh_key(path: str, scale: float) -> str:
    try:
        tag = f"{path}|{scale}|{os.stat(path).st_mtime_ns}|{_MESH_V}"
    except OSError:
        # Procedural stand-in for a missing file: key on the full path
        # (distinct missing paths must not collide) and the generator
        # version, so regenerated stand-ins invalidate stale entries.
        from tracer_torch.geometry.procedural import STANDIN_V

        tag = f"{path}|{scale}|proc{STANDIN_V}|{_MESH_V}"
    return hashlib.sha1(tag.encode()).hexdigest()


def _mesh_file(d: str, path: str, scale: float) -> str:
    return os.path.join(d, f"{PREFIX}mesh-{_mesh_key(path, scale)}.npz")


def load_mesh(path: str, scale: float):
    """The cached mesh of (``path``, ``scale``), or None."""
    from tracer_torch.geometry.obj import MaterialData, MeshData

    d = _cache_dir()
    z = None if d is None else _read(_mesh_file(d, path, scale))
    if z is None:
        return None
    try:
        mats = [
            MaterialData(
                diffuse=z["mat_diffuse"][i],
                ambient=z["mat_ambient"][i],
                specular=z["mat_specular"][i],
                illum=int(z["mat_illum"][i]),
                shininess=float(z["mat_shininess"][i]),
                ior=float(z["mat_ior"][i]),
            )
            for i in range(z["mat_illum"].shape[0])
        ]
        return MeshData(vertices=z["vertices"], normals=z["normals"], indices=z["indices"],
                        mat_ids=z["mat_ids"], materials=mats)
    except (KeyError, IndexError):
        return None


def save_mesh(path: str, scale: float, mesh) -> None:
    d = _cache_dir()
    if d is None:
        return
    mats = mesh.materials or []
    empty3 = np.zeros((0, 3), np.float32)
    _atomic_savez(
        _mesh_file(d, path, scale),
        vertices=mesh.vertices,
        normals=mesh.normals,
        indices=mesh.indices,
        mat_ids=mesh.mat_ids,
        mat_diffuse=np.stack([m.diffuse for m in mats]) if mats else empty3,
        mat_ambient=np.stack([m.ambient for m in mats]) if mats else empty3,
        mat_specular=np.stack([m.specular for m in mats]) if mats else empty3,
        mat_illum=np.asarray([m.illum for m in mats], np.int64),
        mat_shininess=np.asarray([m.shininess for m in mats], np.float32),
        mat_ior=np.asarray([m.ior for m in mats], np.float32),
    )


# --- Treelet cache ----------------------------------------------------------

_TB_V = "t1"


def _treelet_file(d: str, fingerprint: str, max_prims: int, T: int) -> str:
    return os.path.join(d, f"{PREFIX}tb-{fingerprint}-{max_prims}-{T}-{_TB_V}.npz")


def load_treelet_host(fingerprint: str, max_prims: int, T: int):
    """The cached ``TreeletHost`` of a mesh with this fingerprint, built
    with leaves of ``max_prims`` and blocks of ``T``; or None."""
    from tracer_torch.accel.treelet import TreeletHost

    d = _cache_dir()
    z = None if d is None else _read(_treelet_file(d, fingerprint, max_prims, T))
    if z is None:
        return None
    try:
        return TreeletHost(top=z["top"], pids=z["pids"], counts=z["counts"], t_lo=z["t_lo"],
                           t_hi=z["t_hi"], box_table=z["box_table"], depth=int(z["depth"]),
                           T=int(z["T"]))
    except KeyError:
        return None


def save_treelet_host(fingerprint: str, max_prims: int, host) -> None:
    d = _cache_dir()
    if d is None:
        return
    _atomic_savez(
        _treelet_file(d, fingerprint, max_prims, host.T),
        top=host.top,
        pids=host.pids,
        counts=host.counts,
        t_lo=host.t_lo,
        t_hi=host.t_hi,
        box_table=host.box_table,
        depth=np.int64(host.depth),
        T=np.int64(host.T),
    )

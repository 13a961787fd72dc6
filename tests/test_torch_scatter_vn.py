"""The vertex-cotangent placement (kernel B2's twin) and the differentiable
hit-attribute fetch against the JAX package.

Streams come from ``chip_smoke.scatter_streams`` (numpy with a seed; the
same cases feed the kernel-vs-twin checks on the card): duplicates with
untouched vertices and V = 1000 (not a multiple of 512), one segment of
20,000 rows among short ones (it spans 78 chunks of ``CHUNK_ROWS`` rows),
V = 1, M below one chunk, M a multiple of it, and segments that start or
end exactly on a chunk edge. The CUDA kernel is held against the twin on
the card in ``tests/test_torch_cuda.py``.

Tolerances:
* against JAX ``_scatter_add_vn`` in "add" mode and against the
  interpret-mode Pallas ``scatter_add_vn_pallas``: rtol 1e-5, with an atol
  of 1e-6 of each vertex's sum of |x|, because the HIGHEST-precision
  one-hot matmul (and XLA's scatter) sum in another order than the
  sequential twin and sums of mixed signs cancel;
* the twin against a numpy sum in the kernel's fixed order, and two runs
  against each other: bitwise. The order: ``np.add.at`` of each chunk of
  ``CHUNK_ROWS`` rows from 0 (stream order within the chunk), then each
  vertex's chunk partials added in chunk order from 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from chip_smoke import scatter_streams
from tracer.geometry import device as jax_device
from tracer.kernels.scatter_vn import scatter_add_vn_pallas

from tracer_torch.geometry import device
from tracer_torch.geometry.procedural import bumpy_blob
from tracer_torch.kernels import scatter_vn

share_cores()

CASES = scatter_streams(0, long_rows=20_000)
IDS = [c[0] for c in CASES]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _chunk_order_sum(sids, svals, V, rows):
    """The kernel's order in numpy: per-chunk ``np.add.at`` partials, then
    each vertex's partials added in chunk order (only the chunks it has
    rows in)."""
    want = np.zeros((V, 6), np.float32)
    for a in range(0, sids.shape[0], rows):
        part = np.zeros((V, 6), np.float32)
        np.add.at(part, sids[a:a + rows], svals[a:a + rows])
        touched = np.unique(sids[a:a + rows])
        want[touched] = want[touched] + part[touched]
    return want


def _close(got, want, ids, vals, V):
    """|got - want| <= 1e-5 |want| + 1e-6 * (each vertex's sum of |x|)."""
    want = np.asarray(want)
    mag = np.zeros((V, 6), np.float64)
    np.add.at(mag, ids, np.abs(vals).astype(np.float64))
    assert got.shape == want.shape == (V, 6)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * mag)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scatter_add_vn_matches_jax_add(case):
    _, ids, vals, V = case
    got = scatter_vn.scatter_add_vn(torch.as_tensor(ids), torch.as_tensor(vals), V).numpy()
    with jax_device.scatter_override("add"):
        want = jax_device._scatter_add_vn(jnp.asarray(ids), jnp.asarray(vals), V, jnp.float32)
    _close(got, want, ids, vals, V)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scatter_add_vn_matches_jax_pallas_interpret(case):
    _, ids, vals, V = case
    got = scatter_vn.scatter_add_vn(torch.as_tensor(ids), torch.as_tensor(vals), V).numpy()
    want = scatter_add_vn_pallas(jnp.asarray(ids), jnp.asarray(vals), V)
    assert want.shape == (V, 6)
    _close(got, want, ids, vals, V)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_segment_place_sums_in_stream_order(case):
    """The twin on the CPU sums in the kernel's fixed order, bit for bit,
    run after run: stream order within each chunk of ``CHUNK_ROWS`` rows,
    then chunk order; untouched vertices are 0."""
    _, ids, vals, V = case
    order = np.argsort(ids, kind="stable")
    sids, svals = ids[order], vals[order]
    want = _chunk_order_sum(sids, svals, V, scatter_vn.CHUNK_ROWS)
    calls, launches = scatter_vn.REFERENCE_CALLS, scatter_vn.KERNEL_LAUNCHES
    runs = [scatter_vn.segment_place(torch.as_tensor(sids), torch.as_tensor(svals), V).numpy()
            for _ in range(2)]
    assert scatter_vn.REFERENCE_CALLS == calls + 2 and scatter_vn.KERNEL_LAUNCHES == launches
    for got in runs:
        assert np.array_equal(_bits(got), _bits(want))
    untouched = np.bincount(ids, minlength=V) == 0
    assert not runs[0][untouched].any()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_segment_place_order_at_another_chunk_length(case, monkeypatch):
    """The twin takes ``CHUNK_ROWS`` from the module, as the kernel's
    wrapper does: at 32 rows every case crosses chunk edges, and the twin
    still sums in the chunk order above, bit for bit. A segment that lies
    inside one chunk sums as the plain sequential scatter-add does."""
    _, ids, vals, V = case
    order = np.argsort(ids, kind="stable")
    sids, svals = ids[order], vals[order]
    monkeypatch.setattr(scatter_vn, "CHUNK_ROWS", 32)
    got = scatter_vn.segment_place(torch.as_tensor(sids), torch.as_tensor(svals), V).numpy()
    assert np.array_equal(_bits(got), _bits(_chunk_order_sum(sids, svals, V, 32)))
    seq = np.zeros((V, 6), np.float32)
    np.add.at(seq, sids, svals)
    chunk = np.arange(sids.shape[0]) // 32
    inside = np.ones(V, bool)  # vertices whose rows all lie in one chunk
    for j in np.unique(sids):
        inside[j] = np.unique(chunk[sids == j]).size == 1
    assert np.array_equal(_bits(got[inside]), _bits(seq[inside]))


def test_segment_place_rejects_other_devices():
    ids = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        scatter_vn.segment_place(ids, torch.zeros((3, 6), device="meta"), 2)


@pytest.fixture(scope="module")
def blob():
    """A small closed mesh (2,256 triangles) and seeded hit ids with many
    repeats, triangle 0 included (the missed lanes' fetch)."""
    mesh = bumpy_blob(24, 24, 1.0, (0.0, 0.0, 0.0))
    rs = np.random.RandomState(3)
    T = mesh.indices.shape[0]
    tri_c = rs.randint(0, T, 4000)
    tri_c[rs.rand(4000) < 0.3] = 0
    g = rs.standard_normal((4000, device.TRI_COLS)).astype(np.float32)
    g[:, 18:] = 0.0  # the material id and the pad carry no cotangent
    return mesh, tri_c, g


def _port_geom(mesh):
    verts = torch.as_tensor(np.asarray(mesh.vertices, np.float32))
    norms = torch.as_tensor(np.asarray(mesh.normals, np.float32))
    idx = torch.as_tensor(mesh.indices.astype(np.int32))
    mat = torch.zeros(idx.shape[0], dtype=torch.int32)
    return device.GeometryBuffers(vertices=verts, normals=norms, indices=idx, mat_ids=mat,
                                  tri_table=device._tri_table(verts, norms, idx, mat))


def _port_fetch_vjp(geom, tri_c, g):
    v = geom.vertices.clone().requires_grad_()
    n = geom.normals.clone().requires_grad_()
    rows = device.fetch_tri_rows(v, n, geom.tri_table, geom.indices, torch.as_tensor(tri_c))
    gv, gn = torch.autograd.grad(rows, (v, n), torch.as_tensor(g))
    return rows.detach(), gv.numpy(), gn.numpy()


def test_fetch_tri_rows_matches_jax(blob):
    """Forward rows bitwise; the VJP to vertices and normals against
    ``jax.vjp`` of the JAX package's ``fetch_tri_rows`` (its Pallas
    placement in interpret mode), at the tolerance stated above."""
    mesh, tri_c, g = blob
    geom = _port_geom(mesh)
    rows, gv, gn = _port_fetch_vjp(geom, tri_c, g)
    jv, jn = jnp.asarray(geom.vertices.numpy()), jnp.asarray(geom.normals.numpy())
    jidx = jnp.asarray(geom.indices.numpy())
    jtable = jax_device._tri_table(jv, jn, jidx, jnp.asarray(geom.mat_ids.numpy()))
    assert np.array_equal(np.asarray(jtable), geom.tri_table.numpy())
    jrows, vjp = jax.vjp(lambda a, b: jax_device.fetch_tri_rows(a, b, jtable, jidx,
                                                                jnp.asarray(tri_c)), jv, jn)
    assert np.array_equal(np.asarray(jrows), rows.numpy())
    jgv, jgn = vjp(jnp.asarray(g))
    idx_n = geom.indices.numpy()[tri_c].reshape(-1)
    corner = np.concatenate([g[:, 0:9].reshape(-1, 3, 3), g[:, 9:18].reshape(-1, 3, 3)],
                            axis=-1).reshape(-1, 6)
    both = np.concatenate([gv, gn], axis=1)
    _close(both, np.concatenate([np.asarray(jgv), np.asarray(jgn)], axis=1),
           idx_n, corner, geom.vertices.shape[0])
    assert np.abs(gv).sum() > 0 and np.abs(gn).sum() > 0


def test_fetch_tri_rows_matches_autograd_of_gather(blob):
    """The custom backward equals autograd through the plain gathers that
    build the table (another summation order: allclose)."""
    mesh, tri_c, g = blob
    geom = _port_geom(mesh)
    _, gv, gn = _port_fetch_vjp(geom, tri_c, g)
    v = geom.vertices.clone().requires_grad_()
    n = geom.normals.clone().requires_grad_()
    rows = device._tri_table(v, n, geom.indices, geom.mat_ids)[torch.as_tensor(tri_c)]
    rv, rn = torch.autograd.grad(rows, (v, n), torch.as_tensor(g))
    idx_n = geom.indices.numpy()[tri_c].reshape(-1)
    corner = np.concatenate([g[:, 0:9].reshape(-1, 3, 3), g[:, 9:18].reshape(-1, 3, 3)],
                            axis=-1).reshape(-1, 6)
    _close(np.concatenate([gv, gn], axis=1), np.concatenate([rv.numpy(), rn.numpy()], axis=1),
           idx_n, corner, geom.vertices.shape[0])


def test_fetch_tri_rows_grads_only_vertices_and_normals(blob):
    """The derived table and the integer ids take no gradient: the backward
    returns cotangents for the vertices and normals alone."""
    mesh, tri_c, g = blob
    geom = _port_geom(mesh)
    v = geom.vertices.clone().requires_grad_()
    n = geom.normals.clone().requires_grad_()
    table = geom.tri_table.clone().requires_grad_()
    rows = device.fetch_tri_rows(v, n, table, geom.indices, torch.as_tensor(tri_c))
    gv, gn, gt = torch.autograd.grad(rows, (v, n, table), torch.as_tensor(g),
                                     allow_unused=True)
    assert gt is None
    assert gv.shape == v.shape and gn.shape == n.shape
    assert gv.abs().sum() > 0 and gn.abs().sum() > 0

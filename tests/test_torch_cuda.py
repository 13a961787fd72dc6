"""Tests that need the card: the CUDA kernels (super-tile hits B1, vertex-
cotangent placement B2, treelet hits B3) against their plain-PyTorch twins,
and the ported frame, gradient step and path-mode frames on the card
against the same on the CPU. They skip where PyTorch sees no CUDA device.

This file imports nothing of JAX, so it also runs on a machine without it;
there ``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances:
* The frame: none, bit for bit. B1 performs the twin's float32 operations
  in the same order without FMA contraction (``tracer_torch/csrc/
  super_hits.cu``), the flat engine's cull and gates use only exactly
  rounded operations on both devices, and the integrator divides by Python
  numbers through ``vec.div`` and takes square roots through ``vec.sqrt``,
  so CPU and card round alike.
* B2: bit for bit against its twin run on a CPU copy (both sum in the
  same fixed order: stream order within each chunk of ``CHUNK_ROWS`` rows,
  then the chunks' partials in chunk order) and between two launches.
* B3 and the path-mode frames: bit for bit. B3 shares B1's Möller test
  (``csrc/moller.cuh``); the warps and the environment lookup take their
  transcendentals in float64 and round them (``math/vec.py``), so the card
  draws the same directions and samples the same texels as the CPU.
* The gradient: two card runs bit for bit. Card against CPU at rtol 1e-4
  with an atol of 1e-5 of each leaf's largest magnitude, not bitwise:
  the reductions over the lanes (the camera's broadcast to every ray, the
  material product's backward) run in CUDA's and cuBLAS's summation
  orders on the card and in the CPU's orders here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (lane_tiles, scatter_streams, synthetic, synthetic_tiles,
                        with_seeded_env)
from tracer_torch import convert
from tracer_torch.accel import flat, lbvh, treelet
from tracer_torch.diff import grad as G
from tracer_torch.geometry.procedural import bumpy_blob
from tracer_torch.kernels import scatter_vn, super_hits, treelet_hits
from tracer_torch.kernels.intersect import make_rays
from tracer_torch.render import progressive
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bits_equal(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_twin(cuda, any_hit, seed):
    args = synthetic(cuda, any_hit, seed)
    launches = super_hits.KERNEL_LAUNCHES
    kt, kp = super_hits.hits2(*args, any_hit)
    torch.cuda.synchronize()
    assert super_hits.KERNEL_LAUNCHES == launches + 1
    rt, rp = super_hits.hits2_reference(*args, any_hit)
    assert _bits_equal(kp, rp) and _bits_equal(kt, rt)
    assert int((kp >= 0).sum()) > 500


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    tb, *rest = synthetic(cuda, False, 0)
    odd = dataclasses.replace(tb, qblocks=tb.qblocks[:, :, :6].contiguous())
    with pytest.raises(ValueError):
        super_hits.hits2(odd, *rest, False)
    cpu_tb = dataclasses.replace(tb, qblocks=tb.qblocks.cpu())
    with pytest.raises(ValueError):
        super_hits.hits2(cpu_tb, *rest, False)


@pytest.fixture(scope="module")
def blob():
    mesh = bumpy_blob(24, 24, 1.0, (0.0, 0.0, 0.0))
    host = treelet.build_host(lbvh.build(*mesh.bboxes(), max_prims=4), T=32)
    idx = mesh.indices.astype(np.int32)
    return mesh, host, idx


def _frame_rays(device, W=41, H=29):
    u = (np.arange(W) + 0.5) / W - 0.5
    v = 0.5 - (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    d = np.stack([uu.ravel(), vv.ravel(), -np.ones(W * H)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.array([[0.1, 0.0, 3.0]], np.float32), (W * H, 1))
    return make_rays(torch.as_tensor(o, device=device), torch.as_tensor(d, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [96, 8])
def test_flat_engine_on_card_matches_cpu(cuda, blob, K):
    """The frame closest hit (through the kernel) and the any-hit query;
    K=8 sends overflowing super-tiles through the id-order sweep."""
    mesh, host, idx = blob
    out = {}
    for dev in ("cpu", cuda):
        tb = treelet.from_host(host, torch.as_tensor(mesh.vertices, device=dev),
                               torch.as_tensor(idx, device=dev))
        rays = _frame_rays(dev)
        bt, bp, conv = flat._run(rays, tb, (41, 29), any_hit=False, K=K)
        occ = flat.any_hit(make_rays(rays.o, rays.d, tmax=2.5), tb)
        out[str(dev)] = (bt, bp, conv, occ)
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert _bits_equal(a, b)
    assert int((out["cpu"][1] >= 0).sum()) > 100 and bool(out["cpu"][2].all())


@pytest.mark.cuda
def test_bunny_frames_on_card_match_cpu(cuda):
    """Two progressive steps of Project: Bunny at 64x48 (the second one
    seeded) give the same accumulator and seed on the card as on the CPU,
    and the card's frames ran the kernel, never the twin."""
    desc = get_scene("Project: Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=64, height=48))
    states = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        st = progressive.init_state(cfg, dev)
        launches, calls = super_hits.KERNEL_LAUNCHES, super_hits.REFERENCE_CALLS
        for _ in range(2):
            progressive.step(scene, cfg, st)
        if dev is cuda:
            assert super_hits.KERNEL_LAUNCHES >= launches + 2
            assert super_hits.REFERENCE_CALLS == calls
        states[str(dev)] = st
    a, b = states["cpu"], states[str(cuda)]
    assert _bits_equal(a.accum, b.accum) and _bits_equal(a.seed_t, b.seed_t)
    assert a.iteration == b.iteration == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", scatter_streams(1, long_rows=50_000),
                         ids=lambda c: c[0])
def test_segment_place_kernel_matches_twin(cuda, case):
    _, ids, vals, V = case
    sids, perm = torch.sort(torch.as_tensor(ids, device=cuda), stable=True)
    svals = torch.as_tensor(vals, device=cuda)[perm].contiguous()
    launches, calls = scatter_vn.KERNEL_LAUNCHES, scatter_vn.REFERENCE_CALLS
    k1 = scatter_vn.segment_place(sids, svals, V)
    k2 = scatter_vn.segment_place(sids, svals, V)
    torch.cuda.synchronize()
    assert scatter_vn.KERNEL_LAUNCHES == launches + 2
    assert scatter_vn.REFERENCE_CALLS == calls
    want = scatter_vn.segment_place_reference(sids.cpu(), svals.cpu(), V)
    assert _bits_equal(k1, k2) and _bits_equal(k1, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 512])
def test_segment_place_kernel_matches_twin_at_other_chunk_lengths(cuda, rows, monkeypatch):
    """The wrapper passes ``CHUNK_ROWS`` to the kernel: at 32 and 512 rows
    the kernel still equals the CPU twin, which reads the same constant."""
    monkeypatch.setattr(scatter_vn, "CHUNK_ROWS", rows)
    for _, ids, vals, V in scatter_streams(2, long_rows=5_000):
        sids, perm = torch.sort(torch.as_tensor(ids, device=cuda), stable=True)
        svals = torch.as_tensor(vals, device=cuda)[perm].contiguous()
        got = scatter_vn.segment_place(sids, svals, V)
        want = scatter_vn.segment_place_reference(sids.cpu(), svals.cpu(), V)
        assert _bits_equal(got, want)


@pytest.mark.cuda
def test_segment_place_kernel_edge_streams(cuda):
    """An empty stream gives zeros; rows with ids outside [0, V) add
    nothing but still count in the chunks (the order is held by numpy:
    per-chunk ``np.add.at`` of the valid rows, then the partials in chunk
    order); a stream that leaves long runs of vertices unnamed gets them
    zeroed."""
    z = scatter_vn.segment_place(torch.zeros(0, dtype=torch.int32, device=cuda),
                                 torch.zeros((0, 6), device=cuda), 5000)
    assert torch.equal(z.cpu(), torch.zeros((5000, 6)))
    rs = np.random.RandomState(3)
    ids = np.sort(np.concatenate([rs.randint(-50, 0, 300), rs.randint(0, 40, 700),
                                  rs.randint(9000, 9100, 600), rs.randint(10_000, 10_100, 300)]))
    vals = rs.standard_normal((ids.shape[0], 6)).astype(np.float32)
    V = 10_000
    got = scatter_vn.segment_place(torch.as_tensor(ids.astype(np.int32), device=cuda),
                                   torch.as_tensor(vals, device=cuda), V)
    want = np.zeros((V, 6), np.float32)
    for a in range(0, ids.shape[0], scatter_vn.CHUNK_ROWS):
        cid, cval = ids[a:a + scatter_vn.CHUNK_ROWS], vals[a:a + scatter_vn.CHUNK_ROWS]
        ok = (cid >= 0) & (cid < V)
        part = np.zeros((V, 6), np.float32)
        np.add.at(part, cid[ok], cval[ok])
        touched = np.unique(cid[ok])
        want[touched] = want[touched] + part[touched]
    assert got.shape == (V, 6) and _bits_equal(got, torch.as_tensor(want))


@pytest.mark.cuda
def test_segment_place_rejects_what_it_cannot_take(cuda):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    vals = torch.zeros((4, 6), device=cuda)
    with pytest.raises(ValueError):
        scatter_vn.segment_place(ids.long(), vals, 3)
    with pytest.raises(ValueError):
        scatter_vn.segment_place(ids, vals[:, :5], 3)
    with pytest.raises(ValueError):
        scatter_vn.segment_place(ids.cpu(), vals, 3)


@pytest.mark.cuda
def test_bunny_gradient_on_card_matches_cpu(cuda):
    """The 64x48 bunny gradient step (target zeros, the bench's settings):
    two card runs are equal bit for bit, ran both kernels and neither
    twin, and agree with the CPU's gradient at the stated tolerance."""
    desc = get_scene("Project: Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(
        desc.cfg, width=64, height=48, loop="scan", max_depth=2))
    grads = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        target = torch.zeros((64 * 48, 3), device=dev)
        counts = [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in (super_hits, scatter_vn)]
        runs = [convert.grads_to_arrays(G.grad_scene(scene, cfg, target)) for _ in range(2)]
        if dev is cuda:
            for m, (launches, calls) in zip((super_hits, scatter_vn), counts):
                assert m.KERNEL_LAUNCHES >= launches + 2 and m.REFERENCE_CALLS == calls
            for k in G.FLOAT_LEAVES:
                assert _bits_equal(torch.as_tensor(runs[0][k]), torch.as_tensor(runs[1][k])), k
        grads[str(dev)] = runs[0]
    for k in G.FLOAT_LEAVES:
        want = grads["cpu"][k]
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(grads[str(cuda)][k], want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_treelet_kernel_matches_twin(cuda, any_hit, seed):
    *args, enear = synthetic_tiles(cuda, any_hit, seed)
    launches = treelet_hits.KERNEL_LAUNCHES
    kt, kp = treelet_hits.hits(*args, any_hit, enear=enear)
    torch.cuda.synchronize()
    assert treelet_hits.KERNEL_LAUNCHES == launches + 1
    rt, rp = treelet_hits.hits_reference(*args, any_hit, enear=enear)
    assert _bits_equal(kp, rp) and _bits_equal(kt, rt)
    assert int((kp >= 0).sum()) > 150


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_treelet_kernel_live_lanes_match_twin(cuda, any_hit, seed):
    """Tiles with 1, 31, 33 and 127 live lanes, a tile with emissions and no
    live lane, and lanes that die mid-stream (``chip_smoke.lane_tiles``)."""
    *args, enear = lane_tiles(cuda, any_hit, seed)
    kt, kp = treelet_hits.hits(*args, any_hit, enear=enear)
    rt, rp = treelet_hits.hits_reference(*args, any_hit, enear=enear)
    assert _bits_equal(kp, rp) and _bits_equal(kt, rt)
    if not any_hit:  # tile 5's axis lanes died on the big triangle at t = tmin = 3
        assert bool((kt[5, :64] == 3.0).all()) and bool((kp[5, :64] == 0.0).all())


@pytest.mark.cuda
def test_treelet_kernel_rejects_what_it_cannot_take(cuda):
    tb, *rest, enear = synthetic_tiles(cuda, False, 0)
    odd = dataclasses.replace(tb, qblocks=tb.qblocks[:, :, :6].contiguous())
    with pytest.raises(ValueError):
        treelet_hits.hits(odd, *rest, False)
    with pytest.raises(ValueError):
        treelet_hits.hits(tb, *rest, False, enear=enear[:, :3])
    cpu_tb = dataclasses.replace(tb, qblocks=tb.qblocks.cpu())
    with pytest.raises(ValueError):
        treelet_hits.hits(cpu_tb, *rest, False)


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("W9 E1 Bunny", 64), ("W9 E2 Bunny", 32)])
def test_path_frames_on_card_match_cpu(cuda, name, size):
    """Two path-mode progressive steps (seeded environment) give the same
    accumulator on the card as on the CPU, and the card's frames ran B3
    (in any-hit mode too for the holdout plane of W9 E2), never its twin."""
    desc = get_scene(name)
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=size, height=size))
    accs = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        scene = with_seeded_env(scene, desc, dev)
        launches, calls = treelet_hits.KERNEL_LAUNCHES, treelet_hits.REFERENCE_CALLS
        st = progressive.render_progressive(scene, cfg, 2)
        if dev is cuda:
            assert treelet_hits.KERNEL_LAUNCHES >= launches + 4
            assert treelet_hits.REFERENCE_CALLS == calls
        accs[str(dev)] = st.accum
    assert _bits_equal(accs["cpu"], accs[str(cuda)])
    assert float(accs["cpu"].max()) > 0

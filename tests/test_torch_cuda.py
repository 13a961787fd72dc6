"""Tests that need the card: the CUDA kernels (super-tile hits B1, B1's
any-hit query ``super_occluded``, vertex-cotangent placement B2, treelet
hits B3, packet phase A's walk, the brute-force engine's ``brute_hits``)
against their plain-PyTorch twins,
and the ported frame, gradient steps and path-mode frames on the card
against the same on the CPU. They skip where PyTorch sees no CUDA device.

This file imports nothing of JAX, so it also runs on a machine without it;
there ``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances:
* B1 on ``synthetic`` and ``super_lanes``: bit for bit against its twin,
  at TQ = 256 and at TQ = 8.
* The any-hit query's kernel on ``OCCLUSION_CASES`` (quarters of 8, 64
  and 256 triangles, overflowing super-tiles, sweeps cut by the round cap,
  lanes blocked before the query, dead windows, rays that graze quarter-box
  faces, edges and corners, rays almost in a triangle's plane aimed just
  outside its quarter's box): flags, t and converged bit for bit against the
  twin route (whose sweep is ungated, so the kernel's sweep gate may not
  close on a quarter that a lane hits), and against the same route on B1's
  kernel (the JAX package's order of launches); two launches equal. The
  kernel's sweep gates equal ``sweep_gates`` on the card and on a CPU copy,
  bit for bit.
* The frame: none, bit for bit. B1 performs the twin's float32 operations
  in the same order without FMA contraction (``tracer_torch/csrc/
  super_hits.cu``), the flat engine's cull and gates use only exactly
  rounded operations on both devices, and the integrator divides by Python
  numbers through ``vec.div`` and takes square roots through ``vec.sqrt``,
  so CPU and card round alike.
* B2: bit for bit against its twin run on a CPU copy (both sum in the
  same fixed order: stream order within each chunk of ``CHUNK_ROWS`` rows,
  then the chunks' partials in chunk order) and between two launches.
* The texel placement (``texel_place``, B2's passes at a row width of 4):
  the same, on a lookup's 1,048,576 rows crowded onto a 32x64 map's
  texels; the texture gradient through it on the card equals the CPU's
  bit for bit (the cotangent rows are the same float32 products on both
  devices, and the placement sums in the same fixed order).
* Packet phase A's walk kernel: every call's state and emissions bit for
  bit against ``_body`` on a copy of the same buffers, and whole queries
  through it bit for bit against the same queries through ``_body``: both
  perform the same exactly rounded float32 operations, NaN-propagating
  min and max, and argmin's lowest slot on ties. The kernel's wrapper
  counts the iterations it launches, so ``_body`` in its place counts
  none.
* B3 and the path-mode frames: bit for bit. B3 shares B1's Möller test
  (``csrc/moller.cuh``); the warps and the environment lookup take their
  transcendentals in float64 and round them (``math/vec.py``), so the card
  draws the same directions and samples the same texels as the CPU.
* The brute-force engine and the Cornell path frames: bit for bit. The
  engine's per-pair Möller test and the shaders use only exactly rounded
  float32 operations and float64 transcendentals, and ``argmin`` keeps the
  first of equal distances on both devices. The engine's kernel
  (``brute_hits``) against its twins on the card: bit for bit, for the
  same reasons (its fold keeps argmin's first index).
* The Cornell path frames with their bounce replayed from a CUDA graph
  against the same frames run eagerly (spans on): bit for bit, since a
  replay launches the eager bounce's kernels on the same inputs.
* The direct-mode frames (analytic primitives, textured planes under
  stratified jitter, the Cornell box's area lights, the bunny through B1 in
  both modes): bit for bit, for the same reasons; Phong's power is taken
  in float64 and rounded.
* The sun's frames (``W9 E3`` on the bunny stand-in, both
  configurations of ``tests/test_torch_sun.py``), ``W9 E2`` under the RGBE
  fixture environment read by the port's PNG decoder, and a checkpoint
  written on the card and resumed on the card and on the CPU: bit for bit,
  for the same reasons.
* The BSP and ``bvh2`` walks: bit for bit (the Möller test of
  ``kernels/intersect``, exactly rounded).
* The gradient (the dragon's single bounce, the direct rows of W2 E5, W6
  E2 and W6 E1 Bunny at 24x24, and the path gradients of W8 E3 at 64x64
  and W9 E1 at 32x32): two card runs bit for bit. Card against
  CPU at rtol 1e-4 with an atol of 1e-5 of each leaf's largest magnitude,
  not bitwise: the reductions over the lanes (the camera's broadcast to
  every ray, the one-hot products' backward) run in CUDA's and cuBLAS's
  summation orders on the card and in the CPU's orders here.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (FIXTURES, OCCLUSION_CASES, WALK_FIELDS, brute_case, lane_tiles,
                        narrow_quarters, occlusion_case, scatter_streams, seeded_env,
                        seeded_texture, sun_desc, super_lanes, synthetic, synthetic_tiles,
                        texel_stream, walk_buffers, walk_twin, with_fixture_model,
                        with_seeded_env, with_standin_mesh)
from tracer_torch import convert, obs
from tracer_torch.accel import flat, lbvh, packet, treelet
from tracer_torch.diff import grad as G
from tracer_torch.geometry.procedural import bumpy_blob
from tracer_torch.kernels import (brute_hits, intersect, phase_a_walk, scatter_vn,
                                  super_hits, super_occluded, texel_place, treelet_hits)
from tracer_torch.kernels.intersect import Rays, make_rays
from tracer_torch.render import integrator, progressive
from tracer_torch.render import texture as tex
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
@pytest.mark.parametrize("tq", [256, 8])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_twin_on_super_lanes(cuda, any_hit, seed, tq):
    """The live-lane and stream-edge cases of ``chip_smoke.super_lanes``;
    at TQ = 8 (``narrow_quarters``) each CTA of a cluster stages 4 of a
    block's 8 triangles."""
    tb, *rest = super_lanes(cuda, any_hit, seed)
    if tq != tb.qblocks.shape[2]:
        tb = narrow_quarters(tb, tq)
    launches = super_hits.KERNEL_LAUNCHES
    kt, kp = super_hits.hits2(tb, *rest, any_hit)
    torch.cuda.synchronize()
    assert super_hits.KERNEL_LAUNCHES == launches + 1
    rt, rp = super_hits.hits2_reference(tb, *rest, any_hit)
    assert _bits_equal(kp, rp) and _bits_equal(kt, rt)
    if tq == 256 and not any_hit:  # sub-tile 5's axis lanes died at t = tmin = 3
        assert bool((kt[0, 640:704] == 3.0).all()) and bool((kp[0, 640:704] == 0.0).all())


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    tb, *rest = synthetic(cuda, False, 0)
    odd = dataclasses.replace(tb, qblocks=tb.qblocks[:, :, :6].contiguous())
    with pytest.raises(ValueError):
        super_hits.hits2(odd, *rest, False)
    cpu_tb = dataclasses.replace(tb, qblocks=tb.qblocks.cpu())
    with pytest.raises(ValueError):
        super_hits.hits2(cpu_tb, *rest, False)
    # Blocks of 3200 columns (1600 a CTA) need more shared memory than a CTA
    # may have: the card refuses the launch and the wrapper raises, never
    # the twin.
    wide = dataclasses.replace(tb, qblocks=torch.zeros((4, 16, 3200), device=cuda))
    calls = super_hits.REFERENCE_CALLS
    with pytest.raises(RuntimeError):
        super_hits.hits2(wide, *rest, False)
    assert super_hits.REFERENCE_CALLS == calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OCCLUSION_CASES))
def test_occluded_kernel_matches_twin(cuda, name):
    """The any-hit query's kernel against its twin route (plain twin) and
    against that route on B1's kernel: flags, t and converged bitwise; a
    second launch gives the same flags; the kernel counted its work."""
    tb, em, max_rounds = occlusion_case(name, cuda)
    launches, calls = super_occluded.KERNEL_LAUNCHES, super_occluded.REFERENCE_CALLS
    counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    kt, kp, kc = super_occluded.occluded(tb, em, max_rounds, counts=counts)
    again = super_occluded.occluded(tb, em, max_rounds)
    torch.cuda.synchronize()
    assert super_occluded.KERNEL_LAUNCHES == launches + 2
    assert super_occluded.REFERENCE_CALLS == calls
    for route in (super_hits.hits2_reference, super_hits.hits2):
        rt, rp, rc = super_occluded.occluded_reference(tb, em, max_rounds, hits=route)
        assert _bits_equal(kp, rp) and _bits_equal(kt, rt) and torch.equal(kc, rc)
    assert _bits_equal(again[1], kp) and torch.equal(again[2], kc)
    assert int((kp > 0).sum()) > int((em.bp0 > 0).sum()) and int(counts[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OCCLUSION_CASES))
def test_kernel_sweep_gates_equal_the_plain_version(cuda, name):
    """The kernel's sweep gate (its device function, ``kernel_sweep_gates``)
    equals ``sweep_gates`` on every (sub-tile, quarter) pair, computed on
    the card and on a CPU copy, bit for bit."""
    tb, em, _ = occlusion_case(name, cuda)
    got = super_occluded.kernel_sweep_gates(tb, em)
    assert torch.equal(got, super_occluded.sweep_gates(tb, em))
    cpu_tb = dataclasses.replace(tb, qbox=tb.qbox.cpu(), qnorm=tb.qnorm.cpu(),
                                 qblocks=tb.qblocks.cpu())
    cpu_em = dataclasses.replace(em, sb=em.sb.cpu(), prune_sub=em.prune_sub.cpu())
    assert torch.equal(got.cpu(), super_occluded.sweep_gates(cpu_tb, cpu_em))
    assert bool(got.any()) and not bool(got.all())


@pytest.mark.cuda
def test_occluded_kernel_rejects_what_it_cannot_take(cuda):
    tb, em, max_rounds = occlusion_case("mixed K=8", cuda)
    cpu_tb = dataclasses.replace(tb, qblocks=tb.qblocks.cpu())
    with pytest.raises(ValueError):
        super_occluded.occluded(cpu_tb, em, max_rounds)
    with pytest.raises(ValueError):
        super_occluded.occluded(tb, em, max_rounds, counts=torch.zeros(3, device=cuda))
    # Quarters of 3200 triangles need more shared memory than a CTA may
    # have: the launch is refused and the wrapper raises, never the twin.
    wide = dataclasses.replace(tb, qblocks=torch.zeros((4, 16, 3200), device=cuda),
                               qbox=torch.zeros((1, 4, 6), device=cuda),
                               qnorm=torch.zeros((1, 4, 8), device=cuda))
    calls = super_occluded.REFERENCE_CALLS
    with pytest.raises(RuntimeError):
        super_occluded.occluded(wide, em, max_rounds)
    assert super_occluded.REFERENCE_CALLS == calls


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
    """The wrapper passes ``CHUNK_ROWS`` to the kernel, which is compiled
    for 32, 256 and 512: at 32 and 512 rows it still equals the CPU twin,
    which reads the same constant."""
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
@pytest.mark.parametrize("rows", [64, 128, 1024])
def test_segment_place_refuses_chunk_lengths_it_is_not_built_for(cuda, rows, monkeypatch):
    """Chunk lengths other than 32, 256 and 512 have no compiled instance:
    the wrapper refuses them before any launch."""
    monkeypatch.setattr(scatter_vn, "CHUNK_ROWS", rows)
    launches = scatter_vn.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="built for chunks"):
        scatter_vn.segment_place(torch.zeros(4, dtype=torch.int32, device=cuda),
                                 torch.zeros((4, 6), device=cuda), 8)
    assert scatter_vn.KERNEL_LAUNCHES == launches


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


def _sorted_texels(cuda, lanes: int, seed: int = 0):
    ids, rows, n = texel_stream(seed, lanes)
    sids, perm = torch.sort(torch.as_tensor(ids, device=cuda), stable=True)
    return sids, torch.as_tensor(rows, device=cuda)[perm].contiguous(), n


@pytest.mark.cuda
def test_texel_place_kernel_matches_twin_on_a_crowded_lookup(cuda):
    """One 512x512 lookup's 1,048,576 rows onto 2,048 texels, crowded as
    the camera rays of a path's first bounce are: two launches and the CPU
    twin agree bit for bit, and the kernel served both calls."""
    sids, srows, n = _sorted_texels(cuda, 262_144)
    assert sids.shape[0] == 1_048_576 and n == 2048
    launches, calls = texel_place.KERNEL_LAUNCHES, texel_place.REFERENCE_CALLS
    k1 = texel_place.place(sids, srows, n)
    k2 = texel_place.place(sids, srows, n)
    torch.cuda.synchronize()
    assert texel_place.KERNEL_LAUNCHES == launches + 2
    assert texel_place.REFERENCE_CALLS == calls
    want = texel_place.place_reference(sids.cpu(), srows.cpu(), n)
    assert _bits_equal(k1, k2) and _bits_equal(k1, want)
    longest = int(torch.bincount(sids.long(), minlength=n).max())
    assert longest > 50 * texel_place.CHUNK_ROWS


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 512])
def test_texel_place_kernel_matches_twin_at_other_chunk_lengths(cuda, rows, monkeypatch):
    monkeypatch.setattr(texel_place, "CHUNK_ROWS", rows)
    for seed in (1, 2):
        sids, srows, n = _sorted_texels(cuda, 20_000, seed)
        got = texel_place.place(sids, srows, n)
        want = texel_place.place_reference(sids.cpu(), srows.cpu(), n)
        assert _bits_equal(got, want)


@pytest.mark.cuda
def test_texel_place_kernel_edge_streams(cuda):
    """An empty stream gives zeros; one row, and a stream below one chunk,
    equal the twin."""
    z = texel_place.place(torch.zeros(0, dtype=torch.int32, device=cuda),
                          torch.zeros((0, 4), device=cuda), 2048)
    assert torch.equal(z.cpu(), torch.zeros((2048, 4)))
    for lanes in (1, 50):
        sids, srows, n = _sorted_texels(cuda, lanes, 3)
        got = texel_place.place(sids, srows, n)
        assert _bits_equal(got, texel_place.place_reference(sids.cpu(), srows.cpu(), n))


@pytest.mark.cuda
def test_texel_place_rejects_what_it_cannot_take(cuda, monkeypatch):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    rows = torch.zeros((4, 4), device=cuda)
    launches = texel_place.KERNEL_LAUNCHES
    for bad in ((ids.long(), rows), (ids, rows[:, :3]), (ids, rows.double()),
                (ids.cpu(), rows), (ids[:3], rows)):
        with pytest.raises(ValueError):
            texel_place.place(*bad, 8)
    monkeypatch.setattr(texel_place, "CHUNK_ROWS", 64)
    with pytest.raises(ValueError, match="built for chunks"):
        texel_place.place(ids, rows, 8)
    assert texel_place.KERNEL_LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("rgbe", [False, True], ids=["ldr", "rgbe"])
def test_texture_gradient_on_card_matches_cpu(cuda, rgbe, monkeypatch):
    """The bilinear environment lookup's gradient of the map through the
    texel placement, crowded directions included: the card ran the kernel
    once, on its own sorted rows it equals the CPU twin bit for bit, and
    the gradient equals the CPU's bit for bit on an LDR map. On an RGBE map
    the exponent's cotangent rows are sums over the three colour channels,
    which the card reduces in another order, so there the gradient is held
    to the CPU's at rtol 1e-5 with an atol of 1e-6 of its largest
    magnitude."""
    rs = np.random.RandomState(4)
    env = torch.as_tensor(seeded_env(rgbe, 5))
    d = rs.standard_normal((65_536, 3)).astype(np.float32)
    d[:40_000] = [0.05, -0.1, -1.0] + 0.01 * d[:40_000]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    g = rs.standard_normal((65_536, 3)).astype(np.float32)
    kind = tex.ENV_RGBE if rgbe else tex.ENV_LDR
    placed, place = [], texel_place.place
    monkeypatch.setattr(texel_place, "place",
                        lambda *a: placed.append((a, place(*a))) or placed[-1][1])
    grads = []
    for dev in ("cpu", cuda):
        leaf = env.to(dev).clone().requires_grad_(True)
        out = tex.environment_map(tex.TextureBuf(leaf, kind), torch.as_tensor(d, device=dev))
        launches = texel_place.KERNEL_LAUNCHES
        (out * torch.as_tensor(g, device=dev)).sum().backward()
        if dev is cuda:
            assert texel_place.KERNEL_LAUNCHES == launches + 1
        grads.append(leaf.grad.cpu())
    (sids, rows, n), got = placed[-1]
    assert _bits_equal(got, texel_place.place_reference(sids.cpu(), rows.cpu(), n))
    assert float(grads[0].abs().sum()) > 0
    if not rgbe:
        assert _bits_equal(grads[0], grads[1])
    else:
        scale = float(grads[0].abs().max())
        np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=1e-5,
                                   atol=1e-6 * scale)


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
            for k in runs[0]:
                assert _bits_equal(torch.as_tensor(runs[0][k]), torch.as_tensor(runs[1][k])), k
        grads[str(dev)] = runs[0]
    for k in grads["cpu"]:
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


def _halved(tb):
    """The same treelet tree around its mesh scaled by 1/2 (exact in
    float32): another mesh whose walk has the same shapes."""
    top, q = tb.top.clone(), tb.qblocks.clone()
    top[:, :, 0:6] *= 0.5
    q[:, 0:9] *= 0.5
    q[:, 11:14] *= 0.25
    q[:, 14] *= 0.125
    return dataclasses.replace(tb, top=top, qblocks=q, qbox=tb.qbox * 0.5, t_lo=tb.t_lo * 0.5,
                               t_hi=tb.t_hi * 0.5)


def _body_run(tb, rays, frame, any_hit, monkeypatch):
    """``packet._run`` with ``_body`` in the walk kernel's place, on a walk
    table of its own: no launch of the kernel."""
    with monkeypatch.context() as m:
        m.setattr(packet, "_iterate", lambda wk, n: [packet._body(wk) for _ in range(n)])
        launches = phase_a_walk.KERNEL_LAUNCHES
        out = packet._run(rays, dataclasses.replace(tb), frame, any_hit)
        assert phase_a_walk.KERNEL_LAUNCHES == launches
    return out


@pytest.mark.cuda
def test_phase_a_graph_walks_as_the_eager_loop(cuda, monkeypatch):
    """Packet phase A through its walk kernel, one direct launch a batch
    (the name is from when a batch replayed a CUDA graph), against the
    same walk with ``_body`` in the kernel's place on the card: W9 E1's
    first-bounce wavefront at 128x128, closest hit and any hit,
    ``K_EMIT`` = 16 so tiles pause for several rounds: bt, bp and conv bit
    for bit. A second tree in the same process (the bunny's scaled by 1/2,
    so its walk has the same shapes and key) walks from a table of its own
    and gives its own answer. Over three frames each key keeps its one
    ``_Walk`` and every walk iteration runs in the kernel."""
    desc = get_scene("W9 E1 Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=128, height=128))
    scene, cfg = build_scene(desc, cuda)
    scene = with_seeded_env(scene, desc, cuda)
    rays, _ = integrator._path_primary(scene, cfg)
    half = Rays(rays.o * 0.5, rays.d, rays.tmin * 0.5, rays.tmax)
    with monkeypatch.context() as m:
        m.setattr(packet, "K_EMIT", 16)
        rounds = []
        dispatch = packet._dispatch_hits
        m.setattr(packet, "_dispatch_hits", lambda *a: rounds.append(a[3]) or dispatch(*a))
        for tb, r in ((scene.tb, rays), (_halved(scene.tb), half)):
            for any_hit in (False, True):
                rounds.clear()
                launches = phase_a_walk.KERNEL_LAUNCHES
                got = packet._run(r, tb, None, any_hit)
                assert phase_a_walk.KERNEL_LAUNCHES > launches
                assert len(rounds) > 1 and int(rounds[0].max()) > 16 - 8
                want = _body_run(tb, r, None, any_hit, monkeypatch)
                assert all(_bits_equal(a, b) for a, b in zip(got, want))
                assert int((got[1] >= 0).sum()) > 100 and bool(got[2].all())
            assert len(tb.walks) == 1

    names = ("packet.phase_a_iterations", "packet.phase_a_kernel_iterations")
    st = progressive.init_state(cfg, cuda)
    seen, walks = [], []
    for _ in range(3):
        c0 = obs.counters()
        progressive.step(scene, cfg, st)
        seen.append([obs.counters().get(k, 0) - c0.get(k, 0) for k in names])
        walks.append(dict(scene.tb.walks))
    torch.cuda.synchronize()
    assert len(walks[0]) == 2 and all(w.keys() == walks[0].keys() for w in walks)
    assert all(w[k] is walks[0][k] for w in walks for k in w)
    assert all(c[0] > 0 and c[0] == c[1] for c in seen)


def _edge_rays(tb, device, rows: int = 8):
    """Rays on the top tree's own child boxes (the first ``rows`` rows):
    axis-parallel rays whose origins lie on a slab plane of the box (0 x inf
    = NaN slabs), and rays from the centres of its x faces into it (a near
    of -0 on the hi face, so ``clamp_min`` meets a signed zero)."""
    top = tb.top.cpu().numpy()
    o, d = [], []
    for r in range(min(rows, top.shape[0])):
        for j in range(8):
            lo, hi = top[r, j, 0:3], top[r, j, 3:6]
            if not (lo < hi).all():
                continue  # an empty slot
            c = (lo + hi) * np.float32(0.5)
            o += [[lo[0], c[1], c[2]], [c[0], hi[1], c[2]], [c[0], c[1], lo[2]],
                  [hi[0], c[1], c[2]], [lo[0], c[1], c[2]]]
            d += [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                  [-0.96, 0.25, -0.125], [0.96, -0.25, 0.125]]
    o, d = np.asarray(o, np.float32), np.asarray(d, np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, device=device), torch.as_tensor(d, device=device),
            torch.zeros(len(o), device=device))


@pytest.fixture(scope="module")
def walk_case():
    """W9 E1's first-bounce wavefront at 50x40 after ``_edge_rays``: 19
    tiles, the last one padded with dead rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    desc = get_scene("W9 E1 Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=50, height=40))
    scene, cfg = build_scene(desc, dev)
    rays, _ = integrator._path_primary(scene, cfg)
    eo, ed, et = _edge_rays(scene.tb, dev)
    rays = Rays(torch.cat([eo, rays.o]), torch.cat([ed, rays.d]), torch.cat([et, rays.tmin]),
                torch.cat([torch.full_like(et, 5000.0), rays.tmax]))
    assert rays.o.shape[0] % packet.TILE and -(-rays.o.shape[0] // packet.TILE) == 19
    return scene.tb, rays


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("chunk", [packet.CHUNK_TILES, 3], ids=["one_chunk", "chunks_of_3"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_phase_a_walk_kernel_matches_body(walk_case, monkeypatch, any_hit, chunk, K, n):
    """Every launch of the phase A walk kernel (``n`` iterations) in a
    whole query on ``walk_case``, against ``n`` calls of ``_body`` on a
    copy of the same buffers: cur, level, asc, done, paused, snear, sref,
    eids, enear and en bit for bit; any-hit rounds after the first prune
    occluded lanes at -3e38. Zero nears (the rays from box faces) are met,
    and at ``K_EMIT`` = 16 tiles pause for several rounds."""
    tb, rays = walk_case
    tb = dataclasses.replace(tb)  # a walk table of its own
    direct = packet._iterate
    calls, zeros = [], []

    def checked(wk, m):
        twin = walk_twin(wk)
        for _ in range(m):
            packet._body(twin)
        launches = phase_a_walk.KERNEL_LAUNCHES
        direct(wk, m)
        assert phase_a_walk.KERNEL_LAUNCHES == launches + 1
        differ = [name for name, a, b in zip([*WALK_FIELDS, "eids", "enear", "en"],
                                             walk_buffers(wk), walk_buffers(twin))
                  if not _bits_equal(a, b)]
        assert not differ, f"call {len(calls)}: {differ} differ from _body's"
        calls.append(m)
        zeros.append(bool((wk.enear == 0).any() | (wk.st.snear == 0).any()))

    rounds = []
    dispatch = packet._dispatch_hits
    monkeypatch.setattr(packet, "_iterate", checked)
    monkeypatch.setattr(packet, "CHECK_EVERY", n)
    monkeypatch.setattr(packet, "K_EMIT", K)
    monkeypatch.setattr(packet, "CHUNK_TILES", chunk)
    monkeypatch.setattr(packet, "_dispatch_hits", lambda *a: rounds.append(a[3]) or dispatch(*a))
    _, bp, conv = packet._run(rays, tb, None, any_hit)
    assert calls and set(calls) == {n} and any(zeros)
    assert bool(conv.all()) and int(((bp > 0) if any_hit else (bp >= 0)).sum()) > 50
    if K == 16:
        assert len(rounds) > 1 and int(rounds[0].max()) > 16 - 8


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_packet_queries_through_the_walk_kernel_equal_body(cuda, monkeypatch, any_hit):
    """W9 E1's first-bounce wavefront at 128x128 (one frame of 8x16
    packets) through the packet query, once through the walk kernel and
    once with the walk's dispatch sent to ``_body`` (no kernel): bt, bp and
    conv bit for bit; every walk iteration of the first ran in the
    kernel."""
    desc = get_scene("W9 E1 Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=128, height=128))
    scene, cfg = build_scene(desc, cuda)
    rays, _ = integrator._path_primary(scene, cfg)
    names = ("packet.phase_a_iterations", "packet.phase_a_kernel_iterations")
    c0 = obs.counters()
    got = packet._run(rays, scene.tb, (128, 128), any_hit)
    iters, kernel_iters = (obs.counters().get(k, 0) - c0.get(k, 0) for k in names)
    assert iters > 0 and kernel_iters == iters
    want = _body_run(scene.tb, rays, (128, 128), any_hit, monkeypatch)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert bool(got[2].all()) and int((got[1] > 0 if any_hit else got[1] >= 0).sum()) > 100


@pytest.mark.cuda
def test_phase_a_kernel_iterations_count_what_the_graph_holds(walk_case, monkeypatch):
    """``packet.phase_a_kernel_iterations`` counts what the walk kernel ran
    (the name is from when a batch replayed a CUDA graph): on a whole query
    it equals ``packet.phase_a_iterations``, with one launch for each batch
    that ``_iterate`` takes. ``_body`` sent in the kernel's place walks the
    same query in the same batches to the same answer and adds none."""
    tb, rays = walk_case
    names = ("packet.phase_a_iterations", "packet.phase_a_kernel_iterations")
    batches = []
    iterate = packet._iterate
    monkeypatch.setattr(packet, "_iterate", lambda wk, n: batches.append(n) or iterate(wk, n))

    def run():
        batches.clear()
        c0, launches = obs.counters(), phase_a_walk.KERNEL_LAUNCHES
        got = packet._run(rays, dataclasses.replace(tb), None, False)
        counts = [obs.counters().get(k, 0) - c0.get(k, 0) for k in names]
        return got, counts, phase_a_walk.KERNEL_LAUNCHES - launches, list(batches)

    got, (iters, kernel_iters), launches, kernel_batches = run()
    assert iters > 0 and kernel_iters == iters == sum(kernel_batches)
    assert launches == len(kernel_batches)

    def body_walk(wk, n):
        for _ in range(n):
            packet._body(wk)

    monkeypatch.setattr(phase_a_walk, "walk", body_walk)
    want, counts, launches, body_batches = run()
    assert counts == [iters, 0] and launches == 0 and body_batches == kernel_batches
    assert all(_bits_equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_phase_a_walk_kernel_rejects_what_it_cannot_take(walk_case, monkeypatch):
    tb, _ = walk_case
    dev, D = tb.top.device, max(tb.depth, 1)
    wk = packet._Walk(dataclasses.replace(tb), 8, D, 16, dev)
    phase_a_walk.walk(wk, 1)  # takes what it should
    bad = {"o": wk.o.double(), "inv_d": wk.inv_d.transpose(0, 1).contiguous().transpose(0, 1),
           "en": wk.en.int(), "eids": wk.eids[:, :8].contiguous(), "amax": wk.amax.cpu()}
    for name, x in bad.items():
        odd = copy.copy(wk)
        setattr(odd, name, x)
        with pytest.raises(ValueError):
            phase_a_walk.walk(odd, 4)
    for K in (4, 16):
        small = packet._Walk(dataclasses.replace(tb), 8, D, K, dev)
        with monkeypatch.context() as m:
            m.setattr(packet, "CHUNK_TILES", 4)
            with pytest.raises(ValueError):
                phase_a_walk.walk(small, 4)
    with pytest.raises(ValueError):
        phase_a_walk.walk(wk, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cornell", "seeded64"])
def test_brute_force_on_card_matches_cpu(cuda, kind):
    """The brute-force engine's closest and any-hit queries on the card equal
    the same on the CPU, on ``brute_case``'s edge-aimed, shadow and empty
    rays too."""
    verts, idx, *rays, _ = brute_case(kind, 0)
    out = {}
    for dev in ("cpu", cuda):
        r = Rays(*(torch.as_tensor(x, device=dev) for x in rays))
        v, i = torch.as_tensor(verts, device=dev), torch.as_tensor(idx, device=dev)
        out[str(dev)] = (*intersect.mesh_brute_force(r, v, i),
                         intersect.mesh_brute_force_anyhit(r, v, i))
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert _bits_equal(a, b)
    assert int((out["cpu"][1] >= 0).sum()) > 1000


def _random_mesh(rs, T: int):
    """``T`` random triangles about the origin: (vertices, indices)."""
    c = rs.uniform(-1.0, 1.0, (T, 1, 3))
    verts = (c + rs.normal(0.0, 0.3, (T, 3, 3))).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(3 * T, dtype=np.int32).reshape(T, 3)


def brute_hits_case(name: str, dev):
    """(rays, vertices, indices) on ``dev`` for the brute-force kernel:
    ``brute_case``'s Cornell box (12 triangles) and seeded 64 triangles at
    ray counts that do not fill the last block of 128; random rays on 300
    random triangles (three staged passes, the last partial); the Cornell
    box's triangles four times over, so equal t tie across ids and across
    passes; lanes whose window is empty with tmax a first query's t below
    tmin; and tmin and tmax expanded from one value (stride 0) beside o and
    d read through non-contiguous views."""
    rs = np.random.RandomState(7)
    t = lambda x: torch.as_tensor(x, device=dev)
    if name in ("cornell", "seeded64", "empty"):
        verts, idx, o, d, tmin, tmax, _ = brute_case("seeded64" if name == "seeded64" else
                                                     "cornell", 3, n=4001)
    elif name == "random300":
        verts, idx = _random_mesh(rs, 300)
        o = (rs.normal(0.0, 1.0, (2999, 3)) * 2.0).astype(np.float32)
        d = (rs.uniform(-1.0, 1.0, (2999, 3)) - o).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmin = np.full(2999, 1e-5, np.float32)
        tmax = rs.uniform(0.5, 6.0, 2999).astype(np.float32)
    elif name == "duplicates":
        verts, idx, o, d, tmin, tmax, _ = brute_case("cornell", 4, n=1000)
        idx = np.concatenate([idx, idx[::-1], np.tile(idx, (10, 1)), idx])
    elif name == "stride0":
        verts, idx, o, d, *_ = brute_case("cornell", 5, n=777)
        wide = t(np.concatenate([o, d], axis=1))
        rays = make_rays(wide[:, :3], t(d).t().contiguous().t(), 1e-2, 5000.0)
        assert rays.tmin.stride() == (0,) and rays.o.stride() == (6, 1)
        assert rays.d.stride() == (1, 777)
        return rays, t(verts), t(idx)
    else:
        raise ValueError(name)
    rays = Rays(t(o), t(d), t(tmin), t(tmax))
    if name == "empty":
        best, _ = intersect.mesh_brute_force_reference(rays, t(verts), t(idx))
        lift = t(rs.rand(o.shape[0]) < 0.5)
        rays = Rays(rays.o, rays.d, torch.where(lift, best + 1.0, rays.tmin), best)
        assert bool((rays.tmax < rays.tmin).any())
    return rays, t(verts), t(idx)


BRUTE_HITS_CASES = ("cornell", "seeded64", "random300", "duplicates", "empty", "stride0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", BRUTE_HITS_CASES)
def test_brute_hits_kernel_matches_twin(cuda, name):
    """The brute-force kernel's closest hit (t and id) and any hit equal their
    twins run on the card bit for bit, one launch a query, and the counter
    ``brute.kernel_pairs`` adds rays x triangles a launch."""
    rays, verts, idx = brute_hits_case(name, cuda)
    n, T = rays.o.shape[0], idx.shape[0]
    launches, c0 = brute_hits.KERNEL_LAUNCHES, obs.counters()
    got = (*intersect.mesh_brute_force(rays, verts, idx),
           intersect.mesh_brute_force_anyhit(rays, verts, idx))
    torch.cuda.synchronize()
    assert brute_hits.KERNEL_LAUNCHES == launches + 2
    added = {k: obs.counters().get(k, 0) - c0.get(k, 0) for k in ("brute.pairs",
                                                                  "brute.kernel_pairs")}
    assert added == {"brute.pairs": 2 * n * T, "brute.kernel_pairs": 2 * n * T}
    want = (*intersect.mesh_brute_force_reference(rays, verts, idx),
            intersect.mesh_brute_force_anyhit_reference(rays, verts, idx))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and _bits_equal(a, b)
    if name == "empty":
        dead = ~(rays.tmin <= rays.tmax)
        assert not bool(got[2][dead].any()) and bool(got[2][~dead].any())
    else:
        assert int((got[1] >= 0).sum()) > n // 10
    if name == "duplicates":
        assert not bool((got[1] >= 12).any())  # ties keep the first copy


@pytest.mark.cuda
def test_brute_hits_kernel_rejects_what_it_cannot_take(cuda):
    """On the card the wrapper raises ``ValueError`` for a mesh on another
    device than the rays, and a query of no rays launches nothing."""
    rays, verts, idx = brute_hits_case("cornell", cuda)
    with pytest.raises(ValueError):
        brute_hits.closest(rays, verts.cpu(), idx)
    with pytest.raises(ValueError):
        brute_hits.any_hit(rays, verts, idx.cpu())
    launches = brute_hits.KERNEL_LAUNCHES
    none = Rays(*(x[:0] for x in (rays.o, rays.d, rays.tmin, rays.tmax)))
    t, ids = brute_hits.closest(none, verts, idx)
    assert t.shape == ids.shape == (0,) and brute_hits.any_hit(none, verts, idx).shape == (0,)
    assert brute_hits.KERNEL_LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("W8 E3 Absorption", 64), ("W7 E3 Cornell Box", 32)])
def test_cornell_frames_on_card_match_cpu(cuda, name, size):
    """Two path-mode progressive steps in the Cornell box (the brute-force
    engine, spheres, area-light NEE and the dielectric) give the same
    accumulator on the card as on the CPU, and launch no hand kernel but
    the brute-force engine's."""
    desc = with_fixture_model(get_scene(name))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=size, height=size))
    mods = (super_hits, scatter_vn, treelet_hits)
    counts = [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in mods]
    accs = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        assert cfg.traversal == "brute" and scene.tb is None
        launches = brute_hits.KERNEL_LAUNCHES
        accs[str(dev)] = progressive.render_progressive(scene, cfg, 2).accum
        assert (brute_hits.KERNEL_LAUNCHES > launches) == (dev != "cpu")
    assert _bits_equal(accs["cpu"], accs[str(cuda)])
    assert float(accs["cpu"].max()) > 0 and bool((accs["cpu"] >= 0).all())
    assert [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in mods] == counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["W8 E3 Absorption", "W8 E1 Cornell Box Balls",
                                  "W8 E2 Cornell Box Balls", "W7 E3 Cornell Box"])
def test_cornell_bounce_graph_replays_as_the_eager_bounce(cuda, name):
    """Path frames on the brute-force engine replay their bounce from a CUDA
    graph while spans are off and run it eagerly while spans are on: three
    64x64 frames each way give the same accumulator bit for bit and the
    same bounce, ``brute.pairs`` and ``brute.kernel_pairs`` counts (every
    query runs the brute-force kernel, inside the graph too); the graph is
    captured on the first frame only and replayed once a bounce. An eager
    frame launches the kernel once a query; a replayed one launches it from
    the graph, so the wrapper is not called."""
    desc = with_fixture_model(get_scene(name))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=64, height=64))
    scene, cfg = build_scene(desc, cuda)
    names = ("integrator.bounce_graph_captures", "integrator.bounce_graph_replays",
             "integrator.bounces", "brute.pairs", "brute.kernel_pairs")
    pair_per_query = 64 * 64 * scene.geom.indices.shape[0]
    runs = []
    for spans in (False, True):
        obs.enabled(spans)
        try:
            st = progressive.init_state(cfg, cuda)
            seen = []
            for _ in range(3):
                c0, launches = obs.counters(), brute_hits.KERNEL_LAUNCHES
                progressive.step(scene, cfg, st)
                seen.append([obs.counters().get(k, 0) - c0.get(k, 0) for k in names]
                            + [brute_hits.KERNEL_LAUNCHES - launches])
        finally:
            obs.enabled(False)
        runs.append((st.accum, seen))
    (graphed, g), (eager, e) = runs
    assert _bits_equal(graphed, eager)
    assert float(eager.max()) > 0
    assert [c[0] for c in g] == [1, 0, 0] and all(c[1] == c[2] > 0 for c in g)
    assert all(c[0] == c[1] == 0 for c in e)
    assert [c[2:5] for c in g] == [c[2:5] for c in e] and all(c[3] > 0 for c in e)
    assert all(c[3] == c[4] for c in g + e)
    assert [c[5] for c in g[1:]] == [0, 0]
    assert all(c[5] * pair_per_query == c[4] for c in e)


@pytest.mark.cuda
def test_w8e3_path_gradient_on_card_matches_cpu(cuda):
    """The W8 E3 path gradient at 64x64 (``loop="scan"``, target zeros): two
    card runs equal bit for bit, one more equal to them under
    ``torch.use_deterministic_algorithms`` with no warning but cuBLAS's
    workspace note, no hand kernel but the brute-force engine's launched,
    and the card's gradient
    within rtol 1e-4 and an atol of 1e-5 of each leaf's largest magnitude
    of the CPU's (the backward's reductions sum in other orders)."""
    import warnings

    desc = with_fixture_model(get_scene("W8 E3 Absorption"))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(
        desc.cfg, width=64, height=64, loop="scan"))
    mods = (super_hits, scatter_vn, treelet_hits)
    counts = [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in mods]
    grads = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        target = torch.zeros((64 * 64, 3), device=dev)
        grads[str(dev)] = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    card = grads[str(cuda)]
    again = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            strict = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
        finally:
            torch.use_deterministic_algorithms(False)
    noted = [str(w.message) for w in caught if "CuBLAS" not in str(w.message)]
    assert noted == []
    for k in card:
        assert np.isfinite(card[k]).all(), k
        assert _bits_equal(torch.as_tensor(card[k]), torch.as_tensor(again[k])), k
        assert _bits_equal(torch.as_tensor(card[k]), torch.as_tensor(strict[k])), k
        want = grads["cpu"][k]
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(card[k], want, rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    assert np.abs(card["geom.vertices"]).sum() > 0 and np.abs(card["spheres.center"]).sum() > 0
    assert [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in mods] == counts


@pytest.mark.cuda
def test_w9e1_path_gradient_runs_b3_and_b2(cuda):
    """The W9 E1 path gradient at 32x32, depth 3 (seeded environment): B3
    in the forward and B2 in the backward, never their twins; two card runs
    equal bit for bit and within rtol 1e-4 (atol 1e-5 of each leaf's
    largest magnitude) of the CPU's; and B2 on a path-lane corner stream of
    that backward equal bit for bit to its twin run on a CPU copy, with the
    stream's cotangents and with seeded ones on the same ids."""
    desc = get_scene("W9 E1 Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(
        desc.cfg, width=32, height=32, max_depth=3, loop="scan"))
    grads = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        scene = with_seeded_env(scene, desc, dev)
        target = torch.zeros((32 * 32, 3), device=dev)
        grads[str(dev)] = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    streams = []
    place = scatter_vn.segment_place
    counts = [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in (treelet_hits, scatter_vn)]
    scatter_vn.segment_place = lambda *a: streams.append(a) or place(*a)
    try:
        again = convert.grads_to_arrays(G.grad_scene(scene, cfg, target))
    finally:
        scatter_vn.segment_place = place
    (b3, b3_twin), (b2, b2_twin) = [(m.KERNEL_LAUNCHES - c[0], m.REFERENCE_CALLS - c[1])
                                    for m, c in zip((treelet_hits, scatter_vn), counts)]
    assert b3 >= 2 and b2 == len(streams) >= 1 and b3_twin == b2_twin == 0
    card = grads[str(cuda)]
    for k in card:
        assert np.isfinite(card[k]).all(), k
        assert _bits_equal(torch.as_tensor(card[k]), torch.as_tensor(again[k])), k
        want = grads["cpu"][k]
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(card[k], want, rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    assert np.abs(card["env.data"]).sum() > 0
    sids, svals, V = streams[-1]
    seeded = torch.as_tensor(np.random.RandomState(0).standard_normal(tuple(svals.shape))
                             .astype(np.float32), device=cuda)
    for vals in (svals, seeded):
        got = scatter_vn.segment_place(sids, vals, V)
        want = scatter_vn.segment_place_reference(sids.cpu(), vals.cpu(), V)
        assert _bits_equal(got, want)


# (row, width, height, selections, seeded texture, stand-in mesh)
DIRECT_CARD_CASES = {
    "W1 E4": ("W1 E4", 32, 32, None, False, None),
    "W2 E5 glossy+phong": ("W2 E5", 32, 32, (4, 1), False, None),
    "W3 E3 texture": ("W3 E3", 32, 32, None, True, None),
    "W6 E3 Cornell Box": ("W6 E3 Cornell Box", 64, 64, None, False, None),
    "W6 E1 Bunny": ("W6 E1 Bunny", 64, 48, None, False, None),
    "W5 E3 shadowed bunny": ("W5 E3 Teapot", 64, 48, None, False, "bunny.obj"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(DIRECT_CARD_CASES))
def test_direct_frames_on_card_match_cpu(cuda, key):
    """Two direct-mode progressive steps give the same accumulator on the
    card as on the CPU; the bunny rows ran B1 on the card (the shadowed one
    its any-hit query too, through ``super_occluded``) and never its twin,
    the others no hand kernel."""
    row, w, h, sel, textured, standin = DIRECT_CARD_CASES[key]
    desc = get_scene(row)
    if standin is not None:
        desc = with_standin_mesh(desc, standin)
    elif "Cornell" in row:
        desc = with_fixture_model(desc)
    if sel is not None:
        desc = dataclasses.replace(desc, selection1=sel[0], selection2=sel[1])
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=w, height=h))
    mods = (super_hits, scatter_vn, treelet_hits)
    accs, modes = {}, []
    hits2, occluded = super_hits.hits2, super_occluded.occluded
    super_hits.hits2 = lambda *a: modes.append(bool(a[-1])) or hits2(*a)
    super_occluded.occluded = lambda *a, **kw: modes.append(True) or occluded(*a, **kw)
    try:
        for dev in ("cpu", cuda):
            scene, cfg = build_scene(desc, dev)
            if textured:
                scene = dataclasses.replace(
                    scene, texture=tex.TextureBuf(torch.as_tensor(seeded_texture(), device=dev)),
                    uniforms=dataclasses.replace(scene.uniforms, use_texture=tex.TEX_DEFAULT))
            counts = [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in mods]
            accs[str(dev)] = progressive.render_progressive(scene, cfg, 2).accum
            after = [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in mods]
    finally:
        super_hits.hits2, super_occluded.occluded = hits2, occluded
    assert _bits_equal(accs["cpu"], accs[str(cuda)])
    assert bool(torch.isfinite(accs["cpu"]).all()) and float(accs["cpu"].abs().max()) > 0
    if scene.tb is None:
        assert after == counts
    else:
        assert after[0][0] >= counts[0][0] + 2 and after[0][1] == counts[0][1]
        assert after[1:] == counts[1:]
        assert any(modes) == cfg.shadows


@pytest.mark.cuda
@pytest.mark.parametrize("lit", [False, True], ids=["row", "lit plane"])
def test_sun_frames_on_card_match_cpu(cuda, lit):
    """``W9 E3`` on the bunny stand-in, two steps at 32x32: the card's
    accumulator equals the CPU's, and the card ran B3 in closest-hit and
    any-hit mode (the sun's shadow rays), never its twin."""
    desc = sun_desc(get_scene, lit, 32)
    accs, modes = {}, []
    hits = treelet_hits.hits
    treelet_hits.hits = lambda *a, **k: modes.append(bool(a[-1])) or hits(*a, **k)
    try:
        for dev in ("cpu", cuda):
            scene, cfg = build_scene(desc, dev)
            launches, calls = treelet_hits.KERNEL_LAUNCHES, treelet_hits.REFERENCE_CALLS
            modes.clear()
            accs[str(dev)] = progressive.render_progressive(
                with_seeded_env(scene, desc, dev), cfg, 2).accum
    finally:
        treelet_hits.hits = hits
    assert treelet_hits.KERNEL_LAUNCHES >= launches + 4 and treelet_hits.REFERENCE_CALLS == calls
    assert set(modes) == {False, True}
    assert _bits_equal(accs["cpu"], accs[str(cuda)])
    assert float(accs["cpu"].max()) > 0


@pytest.mark.cuda
def test_checkpoint_resume_on_card(cuda, tmp_path):
    """``W9 E1 Bunny`` at 32x32: 3 steps straight on the card equal 2 steps
    checkpointed on the card and resumed to 3, on the card and on the CPU."""
    desc = get_scene("W9 E1 Bunny")
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=32, height=32))
    scenes = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        scenes[str(dev)] = with_seeded_env(scene, desc, dev)
    card = scenes[str(cuda)]
    straight = progressive.render_progressive(card, cfg, 3)
    ck = str(tmp_path / "ck.npz")
    progressive.render_progressive(card, cfg, 2, checkpoint_path=ck, checkpoint_every=2)
    for dev in (cuda, "cpu"):
        st = progressive.load_checkpoint(ck, cfg, dev)
        assert st.iteration == 2 and st.accum.device.type == torch.device(dev).type
        st = progressive.render_progressive(scenes[str(dev)], cfg, 3, state=st)
        assert _bits_equal(st.accum, straight.accum) and _bits_equal(st.seed_t, straight.seed_t)


@pytest.mark.cuda
def test_rgbe_fixture_environment_on_card_matches_cpu(cuda):
    """``W9 E2 Bunny`` at 32x32 with ``tests/fixtures/tiny_env.hdr.png`` as
    its environment, read by the build (``load_rgbe_png``): two steps equal
    on the card and on the CPU."""
    desc = get_scene("W9 E2 Bunny")
    desc = dataclasses.replace(desc, hdri=str(FIXTURES / "tiny_env.hdr.png"),
                               cfg=dataclasses.replace(desc.cfg, width=32, height=32))
    accs = {}
    for dev in ("cpu", cuda):
        scene, cfg = build_scene(desc, dev)
        assert scene.env is not None and scene.env.kind == tex.ENV_RGBE
        accs[str(dev)] = progressive.render_progressive(scene, cfg, 2).accum
    assert _bits_equal(accs["cpu"], accs[str(cuda)])


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["bsp", "bvh2"])
def test_walks_on_the_card_equal_the_cpu(cuda, walk):
    """The BSP walk and the ``bvh2`` walk on the card: hit ids, t and
    any-hit masks bit for bit the CPU's on seeded rays around the bunny
    stand-in (the same float32 Möller test, exactly rounded on both
    devices)."""
    from tracer_torch.accel import bsp, traverse
    from tracer_torch.geometry.procedural import standin_for

    mesh = standin_for("bunny.obj")
    rs = np.random.RandomState(4)
    lo, hi = mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
    c, ext = (lo + hi) / 2, float(np.max(hi - lo))
    o = (c + rs.randn(4096, 3) * ext).astype(np.float32)
    d = (c + rs.randn(4096, 3) * ext * 0.3).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(4096) % 4 == 0, np.linalg.norm(o - c, axis=1), 5000.0)
    host = (bsp.build(*mesh.bboxes()) if walk == "bsp"
            else lbvh.build(*mesh.bboxes(), max_prims=4))
    out = []
    for device in (cuda, torch.device("cpu")):
        rays = make_rays(torch.as_tensor(o, device=device), torch.as_tensor(d, device=device),
                         tmin=1e-4, tmax=torch.as_tensor(tmax.astype(np.float32), device=device))
        V = torch.as_tensor(mesh.vertices, device=device)
        I = torch.as_tensor(mesh.indices.astype(np.int32), device=device)
        if walk == "bsp":
            tree = bsp.to_device(host, device)
            t, ids = bsp.bsp_closest_hit(rays, tree, V, I)
            blocked = bsp.bsp_any_hit(rays, tree, V, I)
        else:
            tree = traverse.to_device(host, device)
            t, ids = traverse.bvh_closest_hit(rays, tree, V, I, max_leaf=4)
            blocked = traverse.bvh_any_hit(rays, tree, V, I, max_leaf=4)
        out.append((t, ids, blocked))
    (tk, ik, bk), (tc, ic, bc) = out
    assert int((ic >= 0).sum()) > 500 and int(bc.sum()) > 500
    assert torch.equal(ik.cpu(), ic) and torch.equal(bk.cpu(), bc) and _bits_equal(tk, tc)


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["W2 E5", "W6 E2 Cornell Box", "W6 E1 Bunny"])
def test_direct_gradient_on_the_card_matches_the_cpu(cuda, row):
    """Direct-mode gradients (shadow rays, the transmit, the area lights,
    ``mix_ka`` through B1 and B2 on the bunny) at 24x24: two card runs bit
    for bit, and the card against the CPU at rtol 1e-4 with an atol of 1e-4
    of each leaf's largest magnitude (the reductions' orders differ)."""
    desc = get_scene(row)
    if "Cornell" in row:
        desc = with_fixture_model(desc)
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=24, height=24))
    grads = []
    for device in (cuda, cuda, torch.device("cpu")):
        scene, cfg = build_scene(desc, device)
        target = torch.zeros((24 * 24, 3), device=device)
        grads.append(convert.grads_to_arrays(G.grad_scene(scene, cfg, target)))
    for k, want in grads[2].items():
        assert np.isfinite(grads[0][k]).all(), k
        assert np.array_equal(grads[0][k].view(np.int32), grads[1][k].view(np.int32)), k
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(grads[0][k], want, rtol=1e-4, atol=1e-4 * scale, err_msg=k)

"""Tests that need the card: the CUDA kernel of the super-tile hits stage
against its plain-PyTorch twin, and the ported path on the card against the
same path on the CPU. They skip where PyTorch sees no CUDA device.

This file imports nothing of JAX, so it also runs on a machine without it;
there ``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: none — bit for bit throughout. The kernel performs the twin's
float32 operations in the same order without FMA contraction
(``tracer_torch/csrc/super_hits.cu``), the flat engine's cull and gates use
only exactly rounded operations on both devices, and the integrator divides
by Python numbers through ``vec.div`` and takes square roots through
``vec.sqrt``, so CPU and card round alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import synthetic
from tracer_torch.accel import flat, lbvh, treelet
from tracer_torch.geometry.procedural import bumpy_blob
from tracer_torch.kernels import super_hits
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

"""What the bounce graph of ``tracer_torch.render.integrator`` rests on, on
the CPU (its capture and replay run only on the card:
``tests/test_torch_cuda.py::test_cornell_bounce_graph_replays_as_the_eager_bounce``).

* ``vec.const`` makes one tensor per value, dtype and device, keeps -0.0
  apart from 0.0, and ``vec.div`` divides by it exactly as by a fresh
  tensor.
* The analytic primitives' ``shader_ids`` are their shader tensors read
  once.
* Off the card, with spans on or autograd on, and on an engine that reads
  back inside a bounce, the loop takes no graph.
* A captured bounce is kept for the next frame (another frame counter),
  and not for another configuration, another lane count or another mesh.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from _share_cores import share_cores

from chip_smoke import with_fixture_model
from tracer_torch import obs
from tracer_torch.math import vec
from tracer_torch.render import integrator
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()


@pytest.fixture(scope="module")
def cornell():
    desc = with_fixture_model(get_scene("W8 E3 Absorption"))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=16, height=16))
    return build_scene(desc, "cpu")


def _carry(n: int) -> tuple:
    f = lambda *s: torch.zeros(s, dtype=torch.float32)
    b = lambda: torch.zeros(n, dtype=torch.bool)
    return (f(n, 3), f(n, 3), f(n), f(n), f(n, 3), f(n, 3), b(), b(), b(),
            torch.zeros(n, dtype=torch.int64))


def test_const_is_made_once_per_value_dtype_and_device():
    a = vec.const((0.7, 0.0, 0.7))
    assert vec.const((0.7, 0.0, 0.7)) is a and a.dtype == torch.float32
    assert torch.equal(a, torch.tensor((0.7, 0.0, 0.7), dtype=torch.float32))
    assert vec.const(2.0, torch.float64) is not vec.const(2.0, torch.float32)
    neg, pos = vec.const(-0.0), vec.const(0.0)
    assert neg is not pos
    assert torch.signbit(neg) and not torch.signbit(pos)
    x = torch.linspace(-3.0, 7.0, 1001)
    for c in (3.0, 3.14159265358979, 100.0, 512):
        want = x / torch.tensor(c, dtype=torch.float32)
        assert torch.equal(vec.div(x, c).view(torch.int32), want.view(torch.int32))


def test_shader_ids_are_the_shader_tensors_read_once(cornell):
    spheres = cornell[0].spheres
    ids = spheres.shader_ids
    assert ids == tuple(spheres.shader.tolist()) == (2, 7)
    assert spheres.shader_ids is ids
    assert all(type(i) is int for i in ids)


def test_no_graph_off_the_card_with_spans_or_with_autograd(cornell, monkeypatch):
    scene, cfg = cornell
    carry = _carry(16 * 16)
    with torch.no_grad():
        assert not integrator._graphable(scene, cfg, carry)
    # The same checks with the device's test answered "on the card".
    cuda_like = (type("T", (), {"is_cuda": True})(),) + carry[1:]
    with torch.no_grad():
        assert integrator._graphable(scene, cfg, cuda_like)
        obs.enabled(True)
        try:
            assert not integrator._graphable(scene, cfg, cuda_like)
        finally:
            obs.enabled(False)
        other = dataclasses.replace(cfg, traversal="bvh2")
        assert not integrator._graphable(scene, other, cuda_like)
        direct = dataclasses.replace(cfg, mode="direct")
        assert not integrator._graphable(scene, direct, cuda_like)
    assert not integrator._graphable(scene, cfg, cuda_like)  # autograd on


def test_a_capture_is_kept_for_the_next_frame_only(cornell):
    scene, cfg = cornell
    carry = _carry(16 * 16)
    key = integrator._closure(scene, cfg, carry)
    assert integrator._same(key, integrator._closure(integrator.with_iteration(scene, 7),
                                                     cfg, carry))
    assert integrator._same(key, integrator._closure(dataclasses.replace(scene), cfg, carry))
    assert not integrator._same(
        key, integrator._closure(scene, dataclasses.replace(cfg, max_depth=3), carry))
    assert not integrator._same(key, integrator._closure(scene, cfg, _carry(8 * 8)))
    moved = dataclasses.replace(scene, geom=dataclasses.replace(scene.geom))
    assert not integrator._same(key, integrator._closure(moved, cfg, carry))
    lit = dataclasses.replace(scene, light_indices=scene.light_indices.clone())
    assert not integrator._same(key, integrator._closure(lit, cfg, carry))

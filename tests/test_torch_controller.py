"""The port's camera controller against ``tracer.render.controller``: for
seeded move strings (every key, the arrow aliases, unknown keys, and
forward moves that reach the target, where the dolly clamps), the eye of
``CameraController().run`` equals the JAX package's bit for bit; the
target, up vector, constant and aspect pass through."""

from __future__ import annotations

import numpy as np
import pytest
from _share_cores import share_cores

from tracer.render import camera as jax_camera
from tracer.render import controller as jax_controller

from tracer_torch.render import camera, controller

share_cores()

KEYS = "wasdWASDx"


def _moves(seed: int) -> str:
    rs = np.random.RandomState(seed)
    return "".join(rs.choice(list(KEYS), size=40))


@pytest.mark.parametrize("moves", [_moves(0), _moves(1), _moves(2), "w" * 80, "wwwwsadd"],
                         ids=["seed0", "seed1", "seed2", "clamp", "short"])
def test_run_matches_jax(moves):
    cam = dict(eye=(0.0, 0.4, 2.0), target=(0.0, 0.1, 0.0), up=(0.0, 1.0, 0.0),
               constant=1.5, aspect=16 / 9)
    got = controller.CameraController().run(camera.make_camera(**cam, device="cpu"), moves)
    want = jax_controller.CameraController().run(jax_camera.make_camera(**cam), moves)
    for k in ("eye", "target", "up", "constant", "aspect"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k
    if moves.startswith("w" * 80):
        # The eye stops short of the target: the dolly clamps at one step.
        dist = np.linalg.norm(got.target.numpy() - got.eye.numpy())
        assert 0 < dist <= controller.SPEED + 1e-6


def test_arrow_aliases_and_device():
    cam = camera.make_camera((1.0, 2.0, 3.0), (0.0, 0.0, 0.0), device="cpu")
    c = controller.CameraController()
    for key, alias in (("up", "w"), ("down", "s"), ("left", "a"), ("right", "d")):
        assert np.array_equal(c.update(cam, key).eye.numpy(), c.update(cam, alias).eye.numpy())
    assert c.update(cam, "q") is cam
    assert c.update(cam, "w").eye.device == cam.eye.device

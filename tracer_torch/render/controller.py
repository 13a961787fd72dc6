"""Camera controller (port of ``tracer.render.controller``): WASD/arrow
dolly and orbit, driven by command strings.

The reference's ``CameraController`` (``reference/src/camera.rs:36-112``):
W/S dolly the eye along the view direction (forward clamped so the eye
never crosses the target); A/D orbit the eye around the target at constant
radius by nudging the forward vector along the right axis and
renormalizing. Speed 0.05 per update (``CAMERA_SPEED``,
``src/render_state.rs:31``). Each character of a move string is one
pressed-key tick. The math runs on the host in float64; the camera that
comes back lies on the device of the one that went in.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tracer_torch.render.camera import Camera, make_camera

SPEED = 0.05  # CAMERA_SPEED, render_state.rs:31

_KEYS = {
    "w": "forward", "s": "backward", "a": "left", "d": "right",
    # arrow-key aliases (camera.rs:58-74 treats them identically)
    "up": "forward", "down": "backward", "left": "left", "right": "right",
}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class CameraController:
    """Per-tick update of a camera."""

    speed: float = SPEED

    def update(self, cam: Camera, key: str) -> Camera:
        """Apply one pressed-key tick; returns the updated Camera."""
        action = _KEYS.get(key.lower())
        if action is None:
            return cam
        eye = _host(cam.eye).astype(np.float64)
        target = _host(cam.target).astype(np.float64)
        up = _host(cam.up).astype(np.float64)

        forward = target - eye
        mag = float(np.linalg.norm(forward))
        fn = forward / mag

        if action == "forward" and mag > self.speed:
            eye = eye + fn * self.speed
        if action == "backward":
            eye = eye - fn * self.speed

        right = np.cross(fn, up)
        forward = target - eye
        mag = float(np.linalg.norm(forward))
        if action == "right":
            d = forward + right * self.speed
            eye = target - d / np.linalg.norm(d) * mag
        if action == "left":
            d = forward - right * self.speed
            eye = target - d / np.linalg.norm(d) * mag

        return make_camera(
            eye=eye.astype(np.float32),
            target=_host(cam.target),
            up=_host(cam.up),
            constant=float(_host(cam.constant)),
            aspect=float(_host(cam.aspect)),
            device=cam.eye.device,
        )

    def run(self, cam: Camera, moves: str) -> Camera:
        """Apply a whole move string (one char per tick; 'wwad...')."""
        for ch in moves:
            cam = self.update(cam, ch)
        return cam

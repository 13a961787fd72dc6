"""Pinhole camera and primary-ray generation (port of
``tracer.render.camera``).

The reference camera is a look-at pinhole with a focal "constant"
(``reference/src/camera.rs:13-34``); rays are built from the quad UV
(``get_camera_ray``, ``w9e2.wgsl:224-241``):

    v = normalize(look_at - eye); b1 = normalize(cross(v, up)); b2 = cross(b1, v)
    q = normalize(b1 * (u + jx) * aspect + b2 * (v_uv + jy) + v * d)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tracer_torch.kernels.intersect import Rays, make_rays
from tracer_torch.math import vec


@dataclass(frozen=True)
class Camera:
    """Look-at pinhole camera (float32 tensors on the scene's device)."""

    eye: torch.Tensor  # (3,)
    target: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    constant: torch.Tensor  # () focal distance
    aspect: torch.Tensor  # () width/height of the uv frustum


def make_camera(eye, target, up=(0.0, 1.0, 0.0), constant=1.0, aspect=1.0,
                *, device) -> Camera:
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return Camera(eye=f(eye), target=f(target), up=f(up),
                  constant=f(constant), aspect=f(aspect))


def pixel_uv(width: int, height: int, *, device):
    """Per-pixel quad coords in [-1/2, 1/2), row-major with row 0 at the
    top; returns (u, v), each (H*W,)."""
    xs = vec.div(torch.arange(width, dtype=torch.float32, device=device) + 0.5, width)
    ys = vec.div(torch.arange(height, dtype=torch.float32, device=device) + 0.5, height)
    u = xs - 0.5
    v = 0.5 - ys  # screen row 0 is top => +v up
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # (H, W)
    return uu.reshape(-1), vv.reshape(-1)


def camera_rays(cam: Camera, u, v, jitter=None) -> Rays:
    """Primary rays for uv coords (+ optional per-ray jitter (N, 2))."""
    fwd = vec.normalize(cam.target - cam.eye)
    b1 = vec.normalize(vec.cross(fwd, cam.up))
    b2 = vec.cross(b1, fwd)
    if jitter is not None:
        u = u + jitter[..., 0]
        v = v + jitter[..., 1]
    q = (
        b1 * (u * cam.aspect)[..., None]
        + b2 * v[..., None]
        + fwd * cam.constant
    )
    d = vec.normalize(q)
    o = cam.eye.expand(d.shape)
    return make_rays(o, d)

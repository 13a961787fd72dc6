"""Orthonormal-basis utilities (port of ``tracer.math.onb``).

``rotate_to_normal`` is the Frisvad/Duff branchless basis rotation used by
the reference for cosine-hemisphere sampling (``w9e2.wgsl:169-181``).
"""

from __future__ import annotations

import torch

from tracer_torch.math import vec


def rotate_to_normal(normal, v):
    """Rotate ``v`` (sampled around +z) so that +z maps to ``normal``
    [Frisvad, JGT 16, 2012; Duff et al., JCGT 6, 2017], with the
    reference's 1e-16 sign epsilon."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    signbit = torch.sign(nz + 1.0e-16)
    a = -1.0 / (1.0 + vec.abs(nz))
    b = nx * ny * a
    t0 = vec.vec3(1.0 + nx * nx * a, b, -signbit * nx)
    t1 = vec.vec3(signbit * b, signbit * (1.0 + ny * ny * a), -ny)
    return t0 * v[..., 0:1] + t1 * v[..., 1:2] + normal * v[..., 2:3]


def spherical_direction(sin_theta, cos_theta, phi):
    """Direction from spherical coordinates (polar theta, azimuth phi),
    ``spherical_direction`` (``w9e2.wgsl:186-191``); the sine and cosine of
    phi are taken in float64 and rounded."""
    return vec.vec3(sin_theta * vec.cos(phi), sin_theta * vec.sin(phi), cos_theta)

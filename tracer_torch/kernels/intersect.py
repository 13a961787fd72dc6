"""Ray containers and the triangle test (port of
``tracer.kernels.intersect``, the parts the direct-mode mesh path uses).

Same operation order as the JAX package, so the CPU results agree with it
to the last bit wherever both round each operation to float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tracer_torch.math import vec

INF = 3.0e38


def _safe_denom(denom, tiny: float = 1.0e-20):
    """Sign-preserving clamp away from zero before a reciprocal (keeps the
    backward Jacobian finite in the JAX package; kept here for the same
    forward values)."""
    mag = torch.clamp_min(torch.abs(denom), tiny)
    return torch.where(denom < 0.0, -mag, mag)


@dataclass(frozen=True)
class Rays:
    """A wavefront of rays, SoA over the batch axis."""

    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    tmin: torch.Tensor  # (N,)
    tmax: torch.Tensor  # (N,)


def make_rays(o, d, tmin=1.0e-5, tmax=5000.0) -> Rays:
    """``ray_init`` defaults: tmin=ETA, tmax=5000 (``w9e2.wgsl:45-52``)."""
    o = torch.as_tensor(o, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32, device=o.device)
    batch = o.shape[:-1]
    f = lambda x: torch.as_tensor(
        x, dtype=torch.float32, device=o.device
    ).expand(batch)
    return Rays(o=o, d=d, tmin=f(tmin), tmax=f(tmax))


def triangle_t(rays: Rays, v0, v1, v2, eps_denom: float = 0.0):
    """Möller-style triangle test via cross products; (t, beta, gamma, valid).

    Matches ``intersect_triangle_indexed`` (``w9e2.wgsl:309-351``):
    ``nom = cross(v0 - o, d)``; ``beta = dot(nom, e1)/denom``;
    ``gamma = -dot(nom, e0)/denom``; ``t = dot(v0 - o, n)/denom``.
    """
    e0 = v1 - v0
    e1 = v2 - v0
    o_to_v0 = v0 - rays.o
    n = vec.cross(e0, e1)
    nom = vec.cross(o_to_v0, rays.d)
    denom = _safe_denom(vec.dot(rays.d, n))
    inv = torch.reciprocal(denom)
    beta = vec.dot(nom, e1) * inv
    gamma = -vec.dot(nom, e0) * inv
    t = vec.dot(o_to_v0, n) * inv
    valid = (
        (beta >= 0.0)
        & (gamma >= 0.0)
        & (beta + gamma <= 1.0)
        & (t >= rays.tmin)
        & (t <= rays.tmax)
    )
    if eps_denom:
        valid = valid & (torch.abs(denom) >= eps_denom)
    return t, beta, gamma, valid

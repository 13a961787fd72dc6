"""Ray containers, the sphere, plane and triangle tests and the brute-force
mesh engine (port of ``tracer.kernels.intersect``, the parts the ported
paths use).

Same operation order as the JAX package, so the CPU results agree with it
to the last bit wherever both round each operation to float32. The one
departure is the brute-force engine's Möller numerators: the JAX package
forms them as an (N, 10) x (10, 4C) matrix product, a TPU workaround that
rounds differently from a per-pair test; here every (ray, triangle) pair
forms them with the elementwise operations of ``triangle_t``, which also
keeps the card's result equal to the CPU's bit for bit.

The brute-force engine's two queries run under the spans ``brute.closest``
and ``brute.occluded`` (``tracer_torch.obs``); each call adds its rays
times the mesh's triangles, read from the shapes, to the counter
``brute.pairs``. On CUDA tensors each query is one launch of the hand
kernel ``tracer_torch.kernels.brute_hits`` (which counts
``brute.kernel_pairs``); on CPU tensors it runs its plain twin,
``mesh_brute_force_reference`` or ``mesh_brute_force_anyhit_reference``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tracer_torch import obs
from tracer_torch.kernels import brute_hits
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


def sphere_t(rays: Rays, center, radius):
    """Closest valid root of the sphere quadratic; (t, valid).

    Matches ``intersect_sphere`` (``w9e2.wgsl:353-380``): try the near root,
    fall back to the far root, reject if both outside [tmin, tmax].
    """
    oc = rays.o - center
    a = vec.dot(rays.d, rays.d)
    b2 = vec.dot(oc, rays.d)
    c = vec.dot(oc, oc) - radius * radius
    disc = b2 * b2 - a * c
    # The JAX package's double-where sqrt (its backward at 0 is inf).
    disc_pos = disc > 0.0
    sq = torch.where(disc_pos, vec.sqrt(torch.where(disc_pos, disc, 1.0)), 0.0)
    r0 = (-b2 - sq) / a
    r1 = (-b2 + sq) / a
    r0_ok = (r0 >= rays.tmin) & (r0 <= rays.tmax)
    r1_ok = (r1 >= rays.tmin) & (r1 <= rays.tmax)
    t = torch.where(r0_ok, r0, r1)
    valid = (disc >= 0.0) & (r0_ok | r1_ok)
    return t, valid


def plane_t(rays: Rays, position, normal):
    """Infinite-plane hit distance; (t, valid) (``w9e2.wgsl:386-404``)."""
    denom = _safe_denom(vec.dot(rays.d, normal))
    t = vec.dot(position - rays.o, normal) / denom
    valid = (t >= rays.tmin) & (t <= rays.tmax)
    return t, valid


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


# (ray, triangle) pairs tested at once by the brute-force engine: the
# chunk of triangles shrinks as the wavefront grows, so that its float32
# temporaries stay near 64 MiB each. The chunking does not change the result.
PAIR_BUDGET = 1 << 24


def _triangle_terms(vertices, indices):
    """v0 and the edges and face normal of every triangle, as ``triangle_t``
    forms them: (v0, e0, e1, n), each (T, 3)."""
    idx = indices.long()
    v0, v1, v2 = vertices[idx[:, 0]], vertices[idx[:, 1]], vertices[idx[:, 2]]
    e0 = v1 - v0
    e1 = v2 - v0
    return v0, e0, e1, vec.cross(e0, e1)


def _pair_hits(rays: Rays, tri, tmax):
    """The Möller test of every (ray, triangle) pair of a chunk; (t, ok),
    each (N, C). The numerators are ``triangle_t``'s (beta_num =
    dot(nom, e1), gamma_num = -dot(nom, e0), denom = dot(d, n), t_num =
    dot(v0 - o, n), with nom = cross(v0 - o, d)), and the acceptance rule is
    the JAX package's division-free one (``tracer/kernels/intersect.py``,
    ``mesh_brute_force``): numerator-times-denominator signs, a nonzero
    denominator, and tmin <= t <= ``tmax``."""
    v0, e0, e1, n = (x[None] for x in tri)
    d = rays.d[:, None, :]
    o_to_v0 = v0 - rays.o[:, None, :]
    nom = vec.cross(o_to_v0, d)
    bn = vec.dot(nom, e1)
    gn = -vec.dot(nom, e0)
    dn = vec.dot(d, n)
    tn = vec.dot(o_to_v0, n)
    t = tn / _safe_denom(dn)
    ok = (
        (bn * dn >= 0.0)
        & (gn * dn >= 0.0)
        & ((bn + gn) * dn <= dn * dn)
        & (t >= rays.tmin[:, None])
        & (t <= tmax[:, None])
        & (dn != 0.0)
    )
    return t, ok


def _chunks(n_rays: int, T: int):
    step = max(1, min(T, PAIR_BUDGET // max(n_rays, 1)))
    return range(0, T, step), step


def mesh_brute_force(rays: Rays, vertices, indices):
    """Closest hit over every triangle of the mesh (the reference's brute-force
    loop, ``w5e2.wgsl:230-240``): (t, tri_id), with tri_id == -1 and t =
    tmax on a miss. The hand kernel on CUDA tensors, the twin on CPU
    tensors."""
    obs.count("brute.pairs", rays.o.shape[0] * indices.shape[0])
    with obs.span("brute.closest"):
        if rays.o.is_cuda:
            return brute_hits.closest(rays, vertices, indices)
        return mesh_brute_force_reference(rays, vertices, indices)


def mesh_brute_force_anyhit(rays: Rays, vertices, indices):
    """Any-hit (shadow) variant: whether some triangle has a hit with tmin <=
    t <= tmax (``intersect_trimesh_immediate_return``, ``bsp.wgsl:83-155``).
    The hand kernel on CUDA tensors, the twin on CPU tensors."""
    obs.count("brute.pairs", rays.o.shape[0] * indices.shape[0])
    with obs.span("brute.occluded"):
        if rays.o.is_cuda:
            return brute_hits.any_hit(rays, vertices, indices)
        return mesh_brute_force_anyhit_reference(rays, vertices, indices)


def mesh_brute_force_reference(rays: Rays, vertices, indices):
    """``mesh_brute_force`` in plain PyTorch, the kernel's twin. Of the hits
    with t <= tmax it takes the least t, and of equal t the lowest triangle
    id, and it keeps a hit only where that t is below tmax, as the JAX
    package's ``argmin`` over chunks does."""
    tri = _triangle_terms(vertices, indices)
    starts, step = _chunks(rays.o.shape[0], tri[0].shape[0])
    best_t = rays.tmax
    best_id = torch.full_like(rays.tmax, -1, dtype=torch.int32)
    for lo in starts:
        t, ok = _pair_hits(rays, [x[lo:lo + step] for x in tri], best_t)
        t = torch.where(ok, t, INF)
        j = torch.argmin(t, dim=1)
        t_best = torch.take_along_dim(t, j[:, None], dim=1)[:, 0]
        better = t_best < best_t
        best_t = torch.where(better, t_best, best_t)
        best_id = torch.where(better, (j + lo).to(torch.int32), best_id)
    return best_t, best_id


def mesh_brute_force_anyhit_reference(rays: Rays, vertices, indices):
    """``mesh_brute_force_anyhit`` in plain PyTorch, the kernel's twin."""
    tri = _triangle_terms(vertices, indices)
    starts, step = _chunks(rays.o.shape[0], tri[0].shape[0])
    blocked = torch.zeros_like(rays.tmax, dtype=torch.bool)
    for lo in starts:
        _, ok = _pair_hits(rays, [x[lo:lo + step] for x in tri], rays.tmax)
        blocked = blocked | ok.any(dim=1)
    return blocked

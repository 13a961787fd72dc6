"""Monte-Carlo sampling warps (port of ``tracer.math.sampling``; the
cosine hemisphere of path mode so far).

The cosine-weighted hemisphere of ``setup_indirect``
(``w8e3.wgsl:492-509``): theta = acos(sqrt(1 - x1)), phi = 2 pi x2, rotated
to the shading normal. acos, sin and cos are taken in float64 and rounded
to float32, so the CPU and the card draw the same directions.
"""

from __future__ import annotations

import math

from tracer_torch.math import onb, rng, vec


def cosine_hemisphere(normal, state):
    """Cosine-weighted direction about ``normal``; returns (dir, state')."""
    xi1, state = rng.rnd(state)
    xi2, state = rng.rnd(state)
    theta = vec.acos(vec.sqrt(1.0 - xi1))
    phi = (2.0 * math.pi) * xi2
    tang = onb.spherical_direction(vec.sin(theta), vec.cos(theta), phi)
    return onb.rotate_to_normal(vec.normalize(normal), tang), state

"""Monte-Carlo sampling warps and stratified jitters (port of
``tracer.math.sampling``).

* The cosine-weighted hemisphere of ``setup_indirect``
  (``w8e3.wgsl:492-509``): theta = acos(sqrt(1 - x1)), phi = 2 pi x2,
  rotated to the shading normal. acos, sin and cos are taken in float64
  and rounded to float32, so the CPU and the card draw the same directions.
* Stratified sub-pixel jitters from a fixed-seed PCG stream
  (``compute_jitters``, ``reference/src/bindings/uniform.rs:254-277``):
  plain Python integers and NumPy, so the table is the JAX package's bit
  for bit.
"""

from __future__ import annotations

import math

import numpy as np

from tracer_torch.math import onb, rng, vec

MAX_SUBDIVISION = 10  # reference MAX_SUBDIVISION (uniform.rs:36)


def cosine_hemisphere(normal, state):
    """Cosine-weighted direction about ``normal``; returns (dir, state')."""
    xi1, state = rng.rnd(state)
    xi2, state = rng.rnd(state)
    theta = vec.acos(vec.sqrt(1.0 - xi1))
    phi = (2.0 * math.pi) * xi2
    tang = onb.spherical_direction(vec.sin(theta), vec.cos(theta), phi)
    return onb.rotate_to_normal(vec.normalize(normal), tang), state


class _PcgLcg64Xsh32:
    """rand_pcg's Lcg64Xsh32 (PCG-XSH-RR 64/32) with the reference's
    ``new(0, 0)`` seeding. Python integers masked to 64 bits, so the state
    wraps as the reference's u64 does."""

    MUL = 6364136223846793005
    MASK = (1 << 64) - 1

    def __init__(self, state: int = 0, stream: int = 0):
        self.inc = ((stream << 1) | 1) & self.MASK
        # rand_pcg new(): state = (state + inc) * MUL + inc
        self.state = ((state + self.inc) * self.MUL + self.inc) & self.MASK

    def next_u32(self) -> int:
        s = self.state
        self.state = (s * self.MUL + self.inc) & self.MASK
        xorshifted = (((s >> 18) ^ s) >> 27) & 0xFFFFFFFF
        rot = s >> 59
        return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & 0xFFFFFFFF

    def gen_range_f64(self) -> float:
        """rand's Standard f64 in [0, 1): 53 random bits / 2^53."""
        hi = self.next_u32()
        lo = self.next_u32()
        return ((lo | (hi << 32)) >> 11) / float(1 << 53)


def compute_jitters(pixel_size: float, subdivs: int) -> np.ndarray:
    """Stratified sub-pixel offsets, shape (subdivs**2, 2) float32: a fresh
    PCG stream per table, one offset per cell of a subdivs x subdivs grid
    centred on the pixel; ``subdivs == 1`` gives the single zero jitter."""
    if not (0 < subdivs <= MAX_SUBDIVISION and pixel_size != 0.0):
        raise ValueError(f"subdivs {subdivs} outside 1..{MAX_SUBDIVISION} or a zero pixel")
    if subdivs == 1:
        return np.zeros((1, 2), np.float32)
    prng = _PcgLcg64Xsh32(0, 0)
    step = pixel_size / subdivs
    out = np.empty((subdivs * subdivs, 2), np.float32)
    k = 0
    for i in range(subdivs):
        for j in range(subdivs):
            u1 = prng.gen_range_f64()
            u2 = prng.gen_range_f64()
            out[k, 0] = (u1 + j) * step - pixel_size * 0.5
            out[k, 1] = (u2 + i) * step - pixel_size * 0.5
            k += 1
    return out

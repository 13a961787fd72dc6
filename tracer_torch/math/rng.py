"""Counter-based PRNG, bit for bit the JAX package's (port of
``tracer.math.rng``).

Each pixel is seeded with a TEA-style hash of ``(pixel_index, iteration)``
and then draws floats from an MCG31 generator (``w9e2.wgsl:133-164``). The
state is one u32 derived from a counter, so frames are reproducible and
pixels are independent.

PyTorch has no full uint32 arithmetic, so every u32 value is carried in an
int64 tensor and masked with ``0xFFFFFFFF`` after each operation that can
leave 32 bits. The MCG31 product fits: 1977654935 * (2^32 - 1) < 2^63.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MCG31_A = 1977654935


def _u32(x, device=None):
    """An int64 tensor holding ``x`` as u32 values."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def tea_seed(val0, val1, rounds: int = 16):
    """TEA-based seed hash of two u32 counters; returns ``v0``
    (``prng_xorshift_seed_generator``, ``w9e2.wgsl:132-147``)."""
    v0 = _u32(val0)
    v1 = _u32(val1, device=v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4))
                    & MASK32)) & MASK32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761E))
                    & MASK32)) & MASK32
    return v0


def mcg31(state):
    """One MCG31 step, ``(A * state) & 0x7FFFFFFF`` (``w9e2.wgsl:150-155``);
    the new state doubles as the 31-bit draw."""
    return (state * MCG31_A) & 0x7FFFFFFF


def rnd(state):
    """A float32 in [0, 1) and the advanced state (``w9e2.wgsl:157-160``):
    the 31-bit draw converted to float32 (round to nearest), times 2^-31."""
    state = mcg31(state)
    return state.to(torch.float32) * (1.0 / 2147483648.0), state


def rnd_int(state):
    """A u32 draw in [0, 2^31) and the advanced state (``w9e2.wgsl:163-166``)."""
    state = mcg31(state)
    return state, state


def pixel_seed(pixel_index, iteration, rounds: int = 16):
    """Per-pixel stream seed of a progressive frame: the launch index hashed
    with the frame iteration (``w8e3.wgsl:255-258``)."""
    return tea_seed(pixel_index, iteration, rounds)

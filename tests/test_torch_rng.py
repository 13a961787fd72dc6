"""The port's counter-based PRNG against the JAX package's, bit for bit:
``tea_seed``, ``mcg31``, ``rnd``, ``rnd_int`` and ``pixel_seed`` over about
a million counters from both 32-bit halves (the lowest and the highest
u32 values), at the iterations 0, 1 and 2^31 - 1. Tolerance: none; the
port carries u32 values in int64 tensors masked to 32 bits, and ``rnd``'s
int -> float32 conversion rounds to nearest on both sides.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from tracer.math import rng as jax_rng

from tracer_torch.math import rng

share_cores()

HALF = 1 << 19
COUNTERS = np.concatenate([
    np.arange(HALF, dtype=np.uint64),
    (1 << 32) - 1 - np.arange(HALF, dtype=np.uint64),
])


def _u32(x) -> np.ndarray:
    a = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    return a.astype(np.uint64).astype(np.uint32)


@pytest.mark.parametrize("iteration", [0, 1, (1 << 31) - 1])
def test_pixel_seed_and_draws_bitwise(iteration):
    idx32 = COUNTERS.astype(np.uint32)
    want = jax_rng.pixel_seed(jnp.asarray(idx32), jnp.uint32(iteration))
    got = rng.pixel_seed(torch.as_tensor(COUNTERS.astype(np.int64)), iteration)
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < (1 << 32)
    assert np.array_equal(_u32(got), np.asarray(want))
    # tea_seed is the same hash with the counters in either argument.
    swapped = rng.tea_seed(iteration, torch.as_tensor(COUNTERS[:4096].astype(np.int64)))
    jswapped = jax_rng.tea_seed(jnp.uint32(iteration), jnp.asarray(idx32[:4096]))
    assert np.array_equal(_u32(swapped), np.asarray(jswapped))

    js, ts = want, got
    for _ in range(3):
        jf, js = jax_rng.rnd(js)
        tf, ts = rng.rnd(ts)
        assert tf.dtype == torch.float32
        assert np.array_equal(tf.numpy().view(np.int32), np.asarray(jf).view(np.int32))
        assert np.array_equal(_u32(ts), np.asarray(js))
    ji, js = jax_rng.rnd_int(js)
    ti, ts = rng.rnd_int(ts)
    assert np.array_equal(_u32(ti), np.asarray(ji)) and np.array_equal(_u32(ts), np.asarray(js))


def test_mcg31_over_the_whole_u32_range():
    """The multiplier times any u32 state fits int64: states up to 2^32 - 1."""
    states = COUNTERS.astype(np.uint32)
    want = np.asarray(jax_rng.mcg31(jnp.asarray(states)))
    got = rng.mcg31(torch.as_tensor(COUNTERS.astype(np.int64)))
    assert np.array_equal(_u32(got), want)
    f = rng.rnd(torch.as_tensor(COUNTERS.astype(np.int64)))[0]
    assert float(f.min()) >= 0.0 and float(f.max()) < 1.0

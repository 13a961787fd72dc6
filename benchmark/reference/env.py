"""The seeded environment map, frozen.

A copy of ``seeded_env`` from ``chip_smoke.py`` as of commit 571a042: the
W9 rows' HDRI (``luxo_pxr_campus.jpg``) is not in the repository, so the
benchmark stands an (H, W, 4) float32 map of random 8-bit texels in for
it, drawn from the run's seed. The size is the configuration's
``assumed.env_shape``.
"""

from __future__ import annotations

import numpy as np


def seeded_env(rgbe: bool, seed: int = 0, shape=(32, 64)) -> np.ndarray:
    """(H, W, 4) float32 texels k / 255; RGBE maps get shared exponents
    2^-8 .. 2^7 in the fourth channel."""
    rs = np.random.RandomState(seed % 2 ** 32)
    env = (rs.randint(0, 256, (*shape, 4)) / 255.0).astype(np.float32)
    if rgbe:
        env[..., 3] = (rs.randint(120, 136, shape) / 255.0).astype(np.float32)
    return env

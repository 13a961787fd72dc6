"""What a run's seed draws, shared by the program's side and the
reference's, so that both are handed the same inputs.

* ``start``: the progressive frame counter the window starts from, in
  [0, 2^COUNTER_BITS); it reseeds every random draw of a path frame;
* ``env_seed``: the seeded environment map (configurations with ``env``);
* ``target_seed``: the gradient's target image, uniform in [0, 1).

The camera is the configuration's, as its row states it.
"""

from __future__ import annotations

import numpy as np
import torch

COUNTER_BITS = 20
# The fewest pixels a sampled check compares, however many frames the
# window completes.
MIN_PIXELS = 64


def seeded(config: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed % 2 ** 64)
    return dict(start=int(rng.integers(0, 2 ** COUNTER_BITS)), camera=dict(config["camera"]),
                env_seed=int(rng.integers(0, 2 ** 32)), target_seed=int(rng.integers(0, 2 ** 62)))


def target(inputs: dict, n_pixels: int, device):
    """The (n_pixels, 3) gradient target, uniform in [0, 1), drawn on
    ``device`` from the seed."""
    gen = torch.Generator(device=device).manual_seed(inputs["target_seed"])
    return torch.rand((n_pixels, 3), generator=gen, device=device)


def checked_pixels(config: dict, check: dict, seed: int, frames: int, device):
    """The pixels a frame check compares: all (``check["pixels"] ==
    "all"``), or a sample drawn from the seed of ``check["lanes"] //
    frames`` pixels (at least ``MIN_PIXELS``), so that the reference traces
    about ``lanes`` paths whatever the frame rate."""
    n = config["width"] * config["height"]
    if check.get("pixels") == "all":
        return torch.arange(n, device=device)
    k = min(n, max(MIN_PIXELS, int(check["lanes"]) // max(frames, 1)))
    rng = np.random.default_rng((seed + 1) % 2 ** 64)
    return torch.as_tensor(np.sort(rng.choice(n, size=k, replace=False)), device=device)


def scene_config(config: dict, traffic: dict) -> dict:
    """The configuration's shading with the traffic's ``cfg`` overrides,
    which both sides apply."""
    out = dict(config["scene"])
    out.update(traffic.get("cfg", {}))
    return out

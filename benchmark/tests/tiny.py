"""Tiny CPU versions of the benchmark's cells for its tests: the port's
CPU path (the kernels' plain twins) at a few hundred pixels, the dragon
row on the bunny's stand-in (its normals turned outward, as the dragon
configuration turns its own), with the scene cache switched off."""

import os
import time
from pathlib import Path

import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BUNNY = {"model": "bunny.obj", "standin": {"n_lat": 187, "n_lon": 187, "radius": 0.09,
                                           "center": [-0.02, 0.11, 0.0], "seed": 1,
                                           "flip_normals": True}}
OVERRIDES = {
    "dragon.frames": {"config": dict(BUNNY, width=32, height=18)},
    "dragon.shadowed": {"config": dict(BUNNY, width=32, height=18)},
    "dragon.grad": {"config": dict(BUNNY, width=32, height=18)},
    "bunny_path.frames": {"config": {"width": 16, "height": 16},
                          "traffic": {"check": {"lanes": 256}}},
}
CELLS = tuple(OVERRIDES)


def run(name: str, seed: int = 2_500_000_123, seconds: float = 0.5, trace: bool = False,
        keep=None) -> dict:
    os.environ["TRACER_NO_SCENE_CACHE"] = "1"
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    return harness.run(name, seed, seconds, trace, "cpu", root=ROOT,
                       t_start=time.perf_counter(), overrides=OVERRIDES[name], keep=keep)

"""Progressive rendering state and the frame driver (port of
``tracer.render.progressive``, checkpointing not yet ported).

The state is one device-resident running mean plus the frame counter and
last frame's primary hit distances (the temporal seed of the flat engine).
``step`` updates the accumulator in place, where the JAX package donates
it to a jitted step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tracer_torch.render import integrator
from tracer_torch.render.scene import Scene, SceneConfig


@dataclass
class ProgressiveState:
    accum: torch.Tensor  # (H*W, 3) f32 running mean (linear radiance)
    iteration: int  # u32-valued frame counter
    # (H*W,) f32 last frame's primary mesh-hit distance (0 = no hint). Pure
    # accelerator state: the render is the same with it zeroed.
    seed_t: torch.Tensor


def init_state(cfg: SceneConfig, device) -> ProgressiveState:
    n = cfg.height * cfg.width
    return ProgressiveState(
        accum=torch.zeros((n, 3), dtype=torch.float32, device=device),
        iteration=0,
        seed_t=torch.zeros((n,), dtype=torch.float32, device=device),
    )


def step(scene: Scene, cfg: SceneConfig, state: ProgressiveState) -> ProgressiveState:
    """One progressive frame = one sample pass + accumulation, with the
    accumulator updated in place. Returns ``state``."""
    scene = integrator.with_iteration(scene, state.iteration)
    result, seed_t = integrator.render_sample_seeded(scene, cfg, state.seed_t)
    integrator.accumulate(result, state.accum, state.iteration)
    state.iteration = (state.iteration + 1) & 0xFFFFFFFF
    state.seed_t = seed_t
    return state


def render_progressive(scene: Scene, cfg: SceneConfig, num_samples: int,
                       state: ProgressiveState | None = None) -> ProgressiveState:
    """Drive frames until ``num_samples`` have been accumulated (the
    reference's rendering-thread loop, headless)."""
    if state is None:
        state = init_state(cfg, scene.device)
    for _ in range(state.iteration, num_samples):
        state = step(scene, cfg, state)
    return state


def image(state: ProgressiveState, cfg: SceneConfig) -> np.ndarray:
    """Display-transformed (H, W, 3) image in [0, 1]."""
    disp = integrator.to_display(state.accum, cfg)
    return disp.cpu().numpy().reshape(cfg.height, cfg.width, 3)

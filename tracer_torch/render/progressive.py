"""Progressive rendering state, checkpoint and resume, and the frame loop
(port of ``tracer.render.progressive``).

The state is one device-resident running mean plus the frame counter and
last frame's primary hit distances (the temporal seed of the flat engine).
``step`` updates the accumulator in place, where the JAX package donates
it to a jitted step. Checkpoints are the JAX package's ``.npz`` layout
(``accum``, ``iteration``, ``seed_t``, ``width``, ``height``, ``name``),
so either package resumes the other's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from tracer_torch import obs
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
    accumulator updated in place, autograd off. Returns ``state``."""
    with obs.span("progressive.step"), torch.no_grad():
        scene = integrator.with_iteration(scene, state.iteration)
        result, seed_t = integrator.render_sample_seeded(scene, cfg, state.seed_t)
        integrator.accumulate(result, state.accum, state.iteration)
    state.iteration = (state.iteration + 1) & 0xFFFFFFFF
    state.seed_t = seed_t
    return state


def render_progressive(scene: Scene, cfg: SceneConfig, num_samples: int,
                       state: ProgressiveState | None = None,
                       checkpoint_path: str | None = None,
                       checkpoint_every: int = 0) -> ProgressiveState:
    """Drive frames until ``num_samples`` have been accumulated (the
    reference's rendering-thread loop, headless), writing a checkpoint to
    ``checkpoint_path`` after every ``checkpoint_every``-th frame."""
    if state is None:
        state = init_state(cfg, scene.device)
    for i in range(state.iteration, num_samples):
        state = step(scene, cfg, state)
        if checkpoint_path and checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state, cfg)
    return state


def save_checkpoint(path: str, state: ProgressiveState, cfg: SceneConfig) -> None:
    """Persist (accum, iteration, seed_t, scene name and shape) for a
    resumable render; written to a temporary file, then renamed over
    ``path``."""
    tmp = path + ".tmp"
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    np.savez(
        src,
        accum=state.accum.cpu().numpy(),
        iteration=np.uint32(state.iteration),
        seed_t=state.seed_t.cpu().numpy(),
        width=cfg.width,
        height=cfg.height,
        name=cfg.name,
    )
    os.replace(src, path)


def load_checkpoint(path: str, cfg: SceneConfig, device) -> ProgressiveState:
    """The state saved at ``path`` (by either package), on ``device``. A
    checkpoint without ``seed_t`` resumes with a zero seed (the render is
    the same either way). Raises ``ValueError`` for another resolution."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["width"]) != cfg.width or int(z["height"]) != cfg.height:
            raise ValueError(
                f"{path}: checkpoint resolution {int(z['width'])}x{int(z['height'])}, "
                f"scene {cfg.width}x{cfg.height}")
        n = cfg.height * cfg.width
        accum = np.asarray(z["accum"], np.float32)
        if accum.shape != (n, 3):
            raise ValueError(f"{path}: accumulator of shape {accum.shape}, expected {(n, 3)}")
        seed = z["seed_t"] if "seed_t" in z.files else np.zeros((n,), np.float32)
        return ProgressiveState(
            accum=torch.as_tensor(accum, device=device).clone(),
            iteration=int(z["iteration"]) & 0xFFFFFFFF,
            seed_t=torch.as_tensor(np.asarray(seed, np.float32), device=device).clone(),
        )


def image(state: ProgressiveState, cfg: SceneConfig) -> np.ndarray:
    """Display-transformed (H, W, 3) image in [0, 1]."""
    disp = integrator.to_display(state.accum, cfg)
    return disp.cpu().numpy().reshape(cfg.height, cfg.width, 3)

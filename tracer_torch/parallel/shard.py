"""Multi-device rendering over ``torch.distributed`` (counterpart of
``tracer.parallel.shard``).

Each rank renders one band of whole pixel rows; the scene and its
acceleration structures are replicated on every rank, so the walks need no
traffic between ranks:

* bands start on a multiple of ``BAND_ALIGN`` rows, the flat engine's
  super-tile height (a multiple of the packet engine's 8-row packets), and
  every wavefront of a band tiles by the band's frame, so each ray is
  traced in the same tile as on one device, with the same random stream
  and jitter (frame-wide pixel indices): **a sharded frame equals the
  single-device frame bit for bit**. The JAX package instead pads the flat
  lane array to a multiple of the device count;
* the progressive accumulator and the temporal seed stay band-local; the
  image is all-gathered only on export (``gather_state``, ``gather_image``);
* there may be more ranks than bands: a rank with an empty band renders
  nothing and still joins every collective.

Gradients: ``tracer_torch.diff.grad.grad_scene_sharded``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

from tracer_torch.accel import flat, packet
from tracer_torch.diff.grad import float_leaves, leaf, with_leaves
from tracer_torch.render import integrator, progressive
from tracer_torch.render.progressive import ProgressiveState
from tracer_torch.render.scene import Scene, SceneConfig

BAND_ALIGN = flat.SUP_H
assert BAND_ALIGN % packet.TILE_H == 0


@dataclass(frozen=True)
class RayMesh:
    """The ranks over which pixel bands shard (``make_ray_mesh``)."""

    rank: int
    size: int
    group: object = None  # the process group; None is the default one


def make_ray_mesh(group=None) -> RayMesh:
    """This rank and the size of ``group`` (the default group where None);
    raises without a process group (``distributed.initialize_from_env``)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize_from_env")
    return RayMesh(dist.get_rank(group), dist.get_world_size(group), group)


def band_rows(height: int, rank: int, size: int) -> tuple[int, int]:
    """(first row, rows) of rank ``rank``'s band of ``height`` rows over
    ``size`` ranks: whole ``BAND_ALIGN``-row blocks, as even as they go,
    the last bands short or empty."""
    blocks = -(-height // BAND_ALIGN)
    per = -(-blocks // size) * BAND_ALIGN
    row0 = min(rank * per, height)
    return row0, min(per, height - row0)


def band_of(cfg: SceneConfig, mesh: RayMesh) -> tuple[int, int]:
    return band_rows(cfg.height, mesh.rank, mesh.size)


def shard_state(state: ProgressiveState, cfg: SceneConfig, mesh: RayMesh) -> ProgressiveState:
    """This rank's band of a whole-frame state (fresh, or a resumed
    checkpoint): the accumulator's and seed's rows, copied."""
    row0, rows = band_of(cfg, mesh)
    lo, hi = row0 * cfg.width, (row0 + rows) * cfg.width
    return ProgressiveState(accum=state.accum[lo:hi].clone(), iteration=state.iteration,
                            seed_t=state.seed_t[lo:hi].clone())


def replicate_scene(scene: Scene, mesh: RayMesh) -> Scene:
    """``scene`` with every float leaf broadcast from the group's first
    rank, one broadcast per leaf (each rank builds the same descriptor
    first; this makes the leaves the same bits everywhere)."""
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    leaves = {}
    for key in float_leaves(scene):
        x = leaf(scene, key).contiguous()
        dist.broadcast(x, src=src, group=mesh.group)
        leaves[key] = x
    return with_leaves(scene, leaves)


def sharded_step(mesh: RayMesh):
    """The progressive step of this rank's band: ``step(scene, cfg,
    state)`` on a band-local state (``shard_state``), in place."""

    def step(scene: Scene, cfg: SceneConfig, state: ProgressiveState) -> ProgressiveState:
        band = band_of(cfg, mesh)
        if band[1] == 0:
            state.iteration = (state.iteration + 1) & 0xFFFFFFFF
            return state
        return progressive.step(replace(scene, band=band), cfg, state)

    return step


def gather_rows(x: torch.Tensor, cfg: SceneConfig, mesh: RayMesh) -> torch.Tensor:
    """The whole frame's lanes of a per-lane tensor whose band each rank
    holds, on every rank (one all-gather of the bands, each padded to the
    longest)."""
    longest = band_rows(cfg.height, 0, mesh.size)[1] * cfg.width
    mine = x.new_zeros((longest, *x.shape[1:]))
    mine[:x.shape[0]] = x
    bands = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(bands, mine, group=mesh.group)
    return torch.cat([b[:band_rows(cfg.height, r, mesh.size)[1] * cfg.width]
                      for r, b in enumerate(bands)])


def gather_state(state: ProgressiveState, cfg: SceneConfig, mesh: RayMesh) -> ProgressiveState:
    """The whole frame's state (accumulator and seed) on every rank."""
    return ProgressiveState(accum=gather_rows(state.accum, cfg, mesh),
                            iteration=state.iteration,
                            seed_t=gather_rows(state.seed_t, cfg, mesh))


def gather_image(state: ProgressiveState, cfg: SceneConfig, mesh: RayMesh) -> np.ndarray:
    """The display-transformed (H, W, 3) image, assembled on every rank."""
    disp = integrator.to_display(gather_rows(state.accum, cfg, mesh), cfg)
    return disp.cpu().numpy().reshape(cfg.height, cfg.width, 3)


def render_progressive_sharded(scene: Scene, cfg: SceneConfig, num_samples: int,
                               mesh: RayMesh | None = None) -> ProgressiveState:
    """Progressive render of this rank's band, ``num_samples`` frames;
    returns the band's state (``gather_state`` assembles the frame)."""
    mesh = mesh if mesh is not None else make_ray_mesh()
    scene = replicate_scene(scene, mesh)
    state = shard_state(progressive.init_state(cfg, scene.device), cfg, mesh)
    step = sharded_step(mesh)
    for _ in range(num_samples):
        step(scene, cfg, state)
    return state

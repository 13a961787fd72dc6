"""Faults planted in the program's timed path, which the check must turn
into ``correct`` false. Each takes ``setattr(owner, name, value)`` (a
test's ``monkeypatch.setattr``, or ``calibrate.py --fault``'s, which
restores the original after the run)."""

import torch


def frames_unchanged(setattr):
    """A frame that hands back the state it was handed."""
    from tracer_torch.render import progressive

    setattr(progressive, "step", lambda scene, cfg, state: state)


def half_frame(setattr):
    """Half of the pixel rows left out of every frame."""
    from tracer_torch.render import integrator

    orig = integrator.accumulate

    def half(result, accum, iteration):
        n = result.shape[0] // 2
        return orig(torch.cat([result[:n], accum[n:]]), accum, iteration)

    setattr(integrator, "accumulate", half)


def frame_altered(setattr):
    """Every frame's radiance a tenth too bright where it is produced."""
    from tracer_torch.render import integrator

    orig = integrator.accumulate
    setattr(integrator, "accumulate", lambda result, accum, it: orig(result * 1.1, accum, it))


def always_blocked(setattr):
    """The any-hit query answers "blocked" for every shadow ray."""
    from tracer_torch.kernels import super_occluded

    orig = super_occluded.occluded

    def blocked(tb, em, max_rounds, counts=None):
        bt, bp, conv = orig(tb, em, max_rounds, counts)
        return bt, torch.ones_like(bp), conv

    setattr(super_occluded, "occluded", blocked)


def skipped_sweep(setattr, short_list: int | None = None):
    """The any-hit query tests the culled list and skips the overflow
    sweep (a round cap of 1). ``short_list``, where given, is the emission
    width ``K`` of the any-hit query's cull, so that a small mesh
    overflows it and the sweep has work to skip."""
    from tracer_torch.kernels import super_occluded

    orig = super_occluded.occluded
    setattr(super_occluded, "occluded",
            lambda tb, em, max_rounds, counts=None: orig(tb, em, 1, counts))
    if short_list:
        short_any_hit(setattr, short_list)


def short_any_hit(setattr, k: int):
    """Not a fault: the any-hit query's cull emits ``k`` treelets a
    super-tile instead of ``flat.K_EMIT``."""
    from tracer_torch.accel import flat

    orig = flat._run
    setattr(flat, "_run", lambda rays, tb, frame, any_hit, **kw: orig(
        rays, tb, frame, any_hit, **(dict(kw, K=k) if any_hit else kw)))


def grad_unchanged(setattr):
    """A step that hands back what it was handed: gradients of zero."""
    from tracer_torch.diff import grad as G

    setattr(G, "_leaf_grads", lambda scene, loss_fn: {
        k: torch.zeros_like(G.leaf(scene, k)) for k in G.float_leaves(scene)})


def grad_half_batch(setattr):
    """The loss's mean taken over half of the pixels."""
    from tracer_torch.diff import grad as G

    def half(scene, cfg, target, num_samples=1):
        img = G.render_mean(scene, cfg, num_samples)
        n = img.shape[0] // 2
        return torch.mean((img[:n] - target[:n]) ** 2)

    setattr(G, "l2_loss", half)


def grad_altered(setattr):
    """The vertex gradient a tenth too large where it is produced."""
    from tracer_torch.diff import grad as G

    orig = G._leaf_grads

    def altered(scene, loss_fn):
        out = orig(scene, loss_fn)
        out["geom.vertices"] = out["geom.vertices"] * 1.1
        return out

    setattr(G, "_leaf_grads", altered)


FRAME = (frames_unchanged, half_frame, frame_altered)
GRAD = (grad_unchanged, grad_half_batch, grad_altered)
ANY_HIT = (always_blocked, skipped_sweep)

"""The gradient loop: ``tracer_torch.diff.grad.grad_scene`` against a
target drawn from the seed, in a closed loop, one
``torch.cuda.synchronize()`` a step, because the optimiser reads every
gradient. The traffic's ``grad_cfg`` replaces fields of the row's
configuration for the step. What it hands the check is the last step's
gradient, leaf by leaf."""

import dataclasses

from benchmark import inputs as inp

UNIT = "step"


def prepare(c, inputs: dict, scene, cfg, device, sync):
    """(one step, ``output(seed, steps)``), after one warm-up step."""
    from tracer_torch.diff import grad as G

    gcfg = dataclasses.replace(cfg, **c.traffic.get("grad_cfg", {}))
    target = inp.target(inputs, cfg.width * cfg.height, device)
    G.grad_scene(scene, gcfg, target)
    sync(device)
    out = {}

    def unit_fn():
        out["g"] = G.grad_scene(scene, gcfg, target)
        sync(device)

    def output(seed: int, steps: int):
        return {k: G.leaf(out["g"], k).detach().clone() for k in G.float_leaves(scene)}, {}

    return unit_fn, output

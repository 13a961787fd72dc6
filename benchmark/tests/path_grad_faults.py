"""Faults planted in the W9 E1 path gradient, which the check of
``bunny_path.grad`` must turn into ``correct`` false. Each takes
``setattr(owner, name, value)``, as those of ``faults.py`` do.

On the card, ``calibrate.py --fault`` finds a fault by name in
``faults.py``; these are put there first:

    python3 -c "import sys; sys.path.insert(0, '.'); from benchmark.tests import faults, \
path_grad_faults as pf; pf.register(faults); from benchmark import calibrate; \
sys.exit(calibrate.main(sys.argv[1:]))" --workload bunny_path.grad --fault env_grad_dropped ...
"""

import types


def env_grad_dropped(setattr):
    """The environment's lookup detached from its texels: ``env.data``'s
    gradient is zero."""
    from tracer_torch.render import integrator, texture

    orig = integrator.tex.environment_map

    def detached(env, direction):
        return orig(texture.TextureBuf(data=env.data.detach(), kind=env.kind), direction)

    setattr(integrator, "tex", types.SimpleNamespace(**dict(vars(integrator.tex),
                                                            environment_map=detached)))


def roulette_prob_detached(setattr):
    """The roulette's probability detached: the throughput's 1 / p carries no
    gradient to the diffuse."""
    from tracer_torch.math import vec
    from tracer_torch.render import integrator

    setattr(integrator, "vec", types.SimpleNamespace(**dict(
        vars(vec), mean3=lambda a: vec.mean3(a).detach())))


def origins_detached(setattr):
    """Every bounce's continuation origins detached: no gradient reaches a
    hit's position through the segments that leave it."""
    from tracer_torch.render import integrator

    orig = integrator._bounce

    def bounce(scene, cfg, carry):
        out = orig(scene, cfg, carry)
        return (out[0].detach(),) + out[1:]

    setattr(integrator, "_bounce", bounce)


PATH_GRAD = (env_grad_dropped, roulette_prob_detached, origins_detached)


def register(module) -> None:
    """Put this file's faults into ``module`` (``faults``) by name."""
    for fault in PATH_GRAD:
        setattr(module, fault.__name__, fault)

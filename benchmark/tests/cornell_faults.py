"""Faults planted in the path-traced Cornell box's shading, which the check
of ``cornell_path.frames`` must turn into ``correct`` false. Each takes
``setattr(owner, name, value)``, as those of ``faults.py`` do.

On the card, ``calibrate.py --fault`` finds a fault by name in
``faults.py``; these are put there first:

    python3 -c "import sys; sys.path.insert(0, '.'); from benchmark.tests import faults, \
cornell_faults as cf; cf.register(faults); from benchmark import calibrate; \
sys.exit(calibrate.main(sys.argv[1:]))" --workload cornell_path.frames --fault beer_dropped ...
"""

import dataclasses


def beer_dropped(setattr):
    """The dielectric's Beer-Lambert transmittance left out: the sphere
    absorbs nothing (the ``fresnel`` variant)."""
    from tracer_torch.render import integrator

    orig = integrator._shade_transparent_path
    setattr(integrator, "_shade_transparent_path",
            lambda scene, cfg, *a: orig(scene, dataclasses.replace(cfg, dielectric="fresnel"),
                                        *a))


def light_count_dropped(setattr):
    """Next-event estimation without its factor ``L``, the number of light
    triangles it draws one of."""
    from tracer_torch.render import integrator

    orig = integrator._sample_area_light_mc

    def one(scene, pos, light_slot, state):
        l_i, w_i, dist, state = orig(scene, pos, light_slot, state)
        return l_i / float(scene.light_indices.shape[0]), w_i, dist, state

    setattr(integrator, "_sample_area_light_mc", one)


def shadows_miss_spheres(setattr):
    """Shadow rays that see the mesh alone: the spheres cast no shadow."""
    from tracer_torch.render import integrator

    orig = integrator.trace_occluded
    setattr(integrator, "trace_occluded",
            lambda scene, cfg, rays: orig(dataclasses.replace(scene, spheres=None), cfg, rays))


CORNELL = (beer_dropped, light_count_dropped, shadows_miss_spheres)


def register(module) -> None:
    """Put this file's faults into ``module`` (``faults``) by name."""
    for fault in CORNELL:
        setattr(module, fault.__name__, fault)

"""``build_s``: the program's host build of the scene (``scenes.build``), the
total of ``build_scene(timings=...)``, in seconds."""


def read(probe):
    return probe.build_timings.get("total")

"""Time the any-hit query's kernel against other checkouts' and the old
route, in turns, on one card.

    python3 occluded_turns.py [--other NAME=DIR ...] [--turns new,old,...] \\
        [--reps 20] [--frames 10] [--out build/occluded_turns.json]

A script beside ``chip_smoke.py`` (it uses the smoke's helpers and
``turns.py``). Routes of the shadowed dragon's any-hit query, by name:

* ``new``: this checkout's ``tracer_torch.kernels.super_occluded.occluded``;
* ``old``: the twin route on B1's kernel (``occluded_reference`` with
  ``hits=super_hits.hits2``: the culled list, then the id-order rounds);
* each ``--other NAME=DIR``: the wrapper and kernel of the checkout at DIR
  (an earlier commit unpacked with ``git archive``, or a variant of this
  one, in a directory that ``.gitignore`` lists), built from DIR's sources.

On the shadowed dragon (``W5 E3 Teapot`` on the stand-in, 800x450: the
directional light's 360,000 shadow rays) it catches one frame's query and
holds every route's flags and converged flags to the old route's, bit for
bit, with each kernel's own counts (work items, visits, live tests) and
the share of the sweep's (sub-tile, quarter) pairs its gate leaves open
(each checkout's plain ``sweep_gates`` on the card; this checkout's also
held to its kernel's gates bit for bit). Then,
for each name of ``--turns`` in order, it times the query (CUDA events over
``--reps`` calls, after one) and the shadowed frame (``progressive.step``,
1 warm-up and ``--frames`` timed, that route serving the frame's query).
It prints every turn and the card's name and power limit, and writes them
as JSON to ``--out``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--turns", default=None,
                    help="comma-separated names (default: old, then new and each other "
                         "forwards and backwards)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", type=Path, default=Path("build/occluded_turns.json"))
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("occluded_turns: torch.cuda.is_available() is false")
    from chip_smoke import (caught_queries, check_sweep_gates, cuda_events_ms, log,
                            occlusion_mismatch, timed_frames, with_standin_mesh)

    import turns as T

    smi = T.card()
    log(smi)

    import tracer_torch
    from tracer_torch.kernels import super_hits, super_occluded
    from tracer_torch.render import progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    dev = tracer_torch.cuda_device()
    mods = {"new": super_occluded}
    for spec in args.other:
        name, _, root = spec.partition("=")
        mods[name] = T.load_wrapper(name, Path(root).resolve(), "super_occluded",
                                    "super_occluded.cu")
    for name, mod in mods.items():
        T.log_build(name, mod.build()[1])
    new_occluded = super_occluded.occluded
    routes = {name: mod.occluded for name, mod in mods.items()}
    routes["old"] = lambda tb, em, max_rounds: super_occluded.occluded_reference(
        tb, em, max_rounds, hits=super_hits.hits2)
    others = [n for n in mods if n != "new"]
    turns = (args.turns.split(",") if args.turns
             else ["old", "new", *others, *others[::-1], "new"])
    T.check_names("occluded_turns", turns, routes)

    desc = with_standin_mesh(get_scene("W5 E3 Teapot"), "dragon.obj")
    scene, cfg = build_scene(desc, dev)
    state = progressive.init_state(cfg, dev)
    with caught_queries() as caught:
        progressive.step(scene, cfg, state)
    (tb, em, max_rounds, _), = caught
    want = routes["old"](tb, em, max_rounds)
    check_sweep_gates("new", tb, em, max_rounds)
    work = {}
    for name, mod in mods.items():
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        got = mod.occluded(tb, em, max_rounds, counts=counts)
        bad = occlusion_mismatch(em, got, want)
        if bad:
            raise AssertionError(f"occluded_turns: {name} differs from the old route on {bad} lanes")
        n_open, n_pairs = super_occluded.open_share(tb, em, mod.sweep_gates(tb, em), max_rounds)
        work[name] = dict(live_tests=int(counts[2]), open_pairs=n_open, sweep_pairs=n_pairs)
        log(f"[check] {name}: flags and converged equal to the old route's on all "
            f"{em.untile(got[1]).numel()} lanes; {int(counts[0])} work items, "
            f"{int(counts[1])} visits, {int(counts[2])} live tests; its gate leaves "
            f"{n_open} of {n_pairs} sweep pairs open ({n_open / max(n_pairs, 1):.4%})")

    rows = []
    for i, name in enumerate(turns):
        fn = routes[name]
        fn(tb, em, max_rounds)
        query_ms = cuda_events_ms(lambda: fn(tb, em, max_rounds),
                                  args.reps if name != "old" else 2)
        super_occluded.occluded = fn
        try:
            st = progressive.init_state(cfg, dev)
            progressive.step(scene, cfg, st)
            frame_ms, frame_host = timed_frames(scene, cfg, st, args.frames)
        finally:
            super_occluded.occluded = new_occluded
        rows.append(dict(turn=i, name=name, query_ms=query_ms, frame_ms=frame_ms,
                         frame_host_ms=frame_host, **work.get(name, {})))
        log(f"[turn {i}] {name}: the query {query_ms:.4f} ms, the shadowed frame "
            f"{frame_ms:.3f} ms/frame (host clock {frame_host:.3f}); {smi}")
    T.write_turns(rows, ("query_ms", "frame_ms"), args.out, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

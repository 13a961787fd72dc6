"""Time kernel B2 against another checkout's B2, in turns, on one card.

    python3 b2_turns.py --parent DIR [--turns parent,new,new,parent] \\
        [--reps 100] [--out build/b2_turns.json]

A script beside ``chip_smoke.py`` (it uses the smoke's helpers and
``turns.py``). Kernels, by name:

* ``new``: this checkout's ``tracer_torch.kernels.scatter_vn.segment_place``;
* ``parent``: the wrapper and kernel of another checkout at DIR (for
  example an earlier commit unpacked with ``git archive`` into a directory
  that ``.gitignore`` lists), built from DIR's own source.

It catches B2's input on one ``Project: Dragon`` gradient step (800x450,
target zeros, ``loop="scan"``, ``max_depth=2``: the sorted corner stream of
the hit-row fetch's backward) and holds both kernels against the twin run
on a CPU copy, bit for bit, and against each other. Then, for each name of
``--turns`` in order, it times the kernel on that stream by CUDA events over
``--reps`` launches and by the profiler's device time. It prints every turn
and the card's name and power limit, and writes them as JSON to ``--out``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--turns", default="parent,new,new,parent")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--out", type=Path, default=Path("build/b2_turns.json"))
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("b2_turns: torch.cuda.is_available() is false")
    from chip_smoke import cuda_events_ms, log, profiled_device_ms

    import turns as T

    smi = T.card()
    log(smi)

    import tracer_torch
    from tracer_torch.diff import grad as G
    from tracer_torch.kernels import scatter_vn
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    dev = tracer_torch.cuda_device()
    parent = T.load_wrapper("parent", args.parent.resolve(), "scatter_vn", "scatter_vn.cu")
    kernels = {"new": scatter_vn.segment_place, "parent": parent.segment_place}
    for name, mod in (("new", scatter_vn), ("parent", parent)):
        T.log_build(name, mod.build()[1])
    turns = args.turns.split(",")
    T.check_names("b2_turns", turns, kernels)

    scene, cfg = build_scene(get_scene("Project: Dragon"), dev)
    gcfg = dataclasses.replace(cfg, loop="scan", max_depth=2)
    caught = []
    place = scatter_vn.segment_place
    scatter_vn.segment_place = lambda *a: caught.append(a) or place(*a)
    try:
        G.grad_scene(scene, gcfg, torch.zeros((cfg.width * cfg.height, 3), device=dev))
    finally:
        scatter_vn.segment_place = place
    (sids, svals, v), = caught
    want = scatter_vn.segment_place_reference(sids.cpu(), svals.cpu(), v)
    for name, fn in kernels.items():
        for _ in range(2):
            got = fn(sids, svals, v).cpu()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"b2_turns: {name} differs from the twin")
    log(f"[b2] the dragon step's stream: M = {sids.shape[0]} rows, V = {v}; both kernels "
        "equal the twin bit for bit, twice")

    rows = []
    for i, name in enumerate(turns):
        fn = kernels[name]
        call = lambda: fn(sids, svals, v)
        call()
        ms = cuda_events_ms(call, args.reps)
        device_ms = profiled_device_ms(call, args.reps, "chunk_sums_kernel")
        rows.append(dict(turn=i, name=name, ms=ms, device_ms=device_ms))
        log(f"[turn {i}] {name}: B2 {ms:.4f} ms per call (CUDA events, {args.reps} calls), "
            f"device {device_ms:.4f} ms (profiler); {smi}")
    T.write_turns(rows, ("ms", "device_ms"), args.out, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

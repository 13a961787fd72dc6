"""Time kernel B1 against another checkout's B1, in turns, on one card.

    python3 b1_turns.py --parent DIR [--turns parent,new,new,parent] \\
        [--reps 50] [--frames 20] [--steps 5] [--out build/b1_turns.json]

A script beside ``chip_smoke.py`` (it uses the smoke's helpers and
``turns.py``). Kernels, by name:

* ``new``: this checkout's ``tracer_torch.kernels.super_hits.hits2``;
* ``parent``: the wrapper and kernel of another checkout at DIR (for
  example an earlier commit unpacked with ``git archive`` into a directory
  that ``.gitignore`` lists), built from DIR's own sources.

On the ``Project: Dragon`` frame (800x450) it first holds both kernels
against the twin, bit for bit, on the seeded frame's closest-hit emissions
and on the any-hit emissions. Then, for each name of ``--turns`` in order,
it times the kernel on the seeded closest-hit emissions (CUDA events over
``--reps`` launches; then the SM clock and power draw from ``nvidia-smi``
while ~0.6 s of launches run), the dragon frame (``progressive.step``: 1 warm-up and
``--frames`` timed) and the dragon gradient step (``grad_scene``, target
zeros, ``loop="scan"``, ``max_depth=2``: 1 warm-up and ``--steps`` timed),
with the flat engine's hits function set to that kernel. It prints every
turn and the card's name and power limit, and writes them as JSON to
``--out``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch


def clock_under(fn, n: int) -> str:
    """The card's SM clock and power draw (``nvidia-smi``), read while ``n``
    back-to-back calls of ``fn`` keep it busy."""
    seen = {}

    def probe():
        time.sleep(0.2)
        seen["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()

    thread = threading.Thread(target=probe)
    thread.start()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    thread.join()
    return seen.get("smi", "not read")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--turns", default="parent,new,new,parent")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=Path("build/b1_turns.json"))
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("b1_turns: torch.cuda.is_available() is false")
    from chip_smoke import compare, cuda_events_ms, frame_args, log

    import turns as T

    smi = T.card()
    log(smi)

    import tracer_torch
    from tracer_torch.accel import flat
    from tracer_torch.diff import grad as G
    from tracer_torch.kernels import super_hits
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    dev = tracer_torch.cuda_device()
    parent = T.load_wrapper("parent", args.parent.resolve(), "super_hits", "super_hits.cu")
    new_hits = super_hits.hits2
    jobs = {"new": lambda: (new_hits, super_hits.build()[1]),
            "parent": lambda: (parent.hits2, parent.build()[1])}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    kernels = {}
    for name, (fn, build_log) in built.items():
        kernels[name] = fn
        T.log_build(name, build_log)
    turns = args.turns.split(",")
    T.check_names("b1_turns", turns, kernels)

    scene, cfg = build_scene(get_scene("Project: Dragon"), dev)
    rays = integrator.primary_rays(scene, cfg)
    frame = (cfg.width, cfg.height)
    state = progressive.init_state(cfg, dev)
    for _ in range(2):
        progressive.step(scene, cfg, state)
    seeded = frame_args(flat.emissions(rays, scene.tb, frame, seed_t=state.seed_t), scene.tb)
    occl = frame_args(flat.emissions(rays, scene.tb, frame, any_hit=True), scene.tb)
    want = {False: super_hits.hits2_reference(*seeded, False),
            True: super_hits.hits2_reference(*occl, True)}
    for name, fn in kernels.items():
        for any_hit, em_args in ((False, seeded), (True, occl)):
            compare(f"{name} {'any-hit' if any_hit else 'closest'}",
                    fn(*em_args, any_hit), want[any_hit])

    gcfg = dataclasses.replace(cfg, loop="scan", max_depth=2)
    target = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32, device=dev)

    def events_ms(fn, n: int) -> float:
        fn()  # warm-up
        torch.cuda.synchronize()
        return cuda_events_ms(fn, n)

    rows = []
    for i, name in enumerate(turns):
        fn = kernels[name]
        fn(*seeded, False)
        kernel_ms = cuda_events_ms(lambda: fn(*seeded, False), args.reps)
        clock = clock_under(lambda: fn(*seeded, False), max(1, int(600 / kernel_ms)))
        super_hits.hits2 = fn
        try:
            st = progressive.init_state(cfg, dev)
            t0 = time.perf_counter()
            frame_ms = events_ms(lambda: progressive.step(scene, cfg, st), args.frames)
            frame_host = (time.perf_counter() - t0) * 1e3 / (args.frames + 1)
            step_ms = events_ms(lambda: G.grad_scene(scene, gcfg, target), args.steps)
        finally:
            super_hits.hits2 = new_hits
        rows.append(dict(turn=i, name=name, kernel_ms=kernel_ms, frame_ms=frame_ms,
                         step_ms=step_ms, clock=clock))
        log(f"[turn {i}] {name}: B1 {kernel_ms:.4f} ms on the seeded frame's emissions "
            f"({args.reps} launches; SM clock, power under it: {clock}), dragon {frame_ms:.3f} ms/frame (host clock "
            f"{frame_host:.3f} with its warm-up), gradient step {step_ms:.3f} ms/step; {smi}")
    T.write_turns(rows, ("kernel_ms", "frame_ms", "step_ms"), args.out, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

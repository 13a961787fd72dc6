"""Readings that the limits of a cell's check are set from.

    python3 benchmark/calibrate.py --workload <name> --seconds <s> --seeds <n> [--first <seed>]
        [--control-seeds <k>] [--fault <name>] [--out <file>]

For each of ``--seeds`` seeds (``--first``, ``--first + 1``, ...) one run
of the cell as ``run.py`` makes it (the window, then the check), keeping
the program's numbers and whether the run was correct: the lower
readings. On the first ``--control-seeds`` of them also the control's:
the reference computed in TF32 put in the program's place, judged by the
same limits on the same inputs: the upper readings. ``--fault`` plants a
fault of ``benchmark/tests/faults.py`` in every run, to read it at the
cell's own size. A gradient cell's rows give each leaf's reference norm
and error. Prints one JSON line per seed and writes them all to
``--out``. Needs a CUDA card, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=3_000_000_000)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as entry

    entry.fixed_caches()
    import torch

    from benchmark import harness
    from benchmark.tests import faults

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        getattr(faults, args.fault)(setattr)
    rows = []
    for i in range(args.seeds):
        seed = args.first + i
        keep: dict = {}
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False, "cuda", root=ROOT,
                          t_start=t0, keep=keep)
        row = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
               "program": keep["numbers"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        if keep["cell"].unit == "step":
            leaves: dict = {}
            harness.reference_numbers(keep["cell"], keep["inputs"], seed, keep["prog"],
                                      keep["mesh"], keep["units"], torch.device("cuda"),
                                      leaves=leaves)
            row["leaves"] = leaves
        if i < args.control_seeds:
            t1 = time.perf_counter()
            ok, _, numbers = harness.control(keep, torch.device("cuda"))
            row["control"] = numbers
            row["control_correct"] = ok
            row["control_s"] = time.perf_counter() - t1
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

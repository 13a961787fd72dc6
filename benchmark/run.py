"""The benchmark of ``tracer_torch`` on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs a CUDA card and exits with
code 2, printing no result, without one. It builds the cell's scene,
warms up one frame or step, measures for ``--seconds`` seconds, checks
what the window produced against the plain reference, and prints one JSON
object as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, ``breakdown``
(traced runs) and, last, ``checks``: each number compared with its limit,
which also end standard error. Builds and caches stay in the checkout,
under ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TRACER_SCENE_CACHE"] = str(BUILD / "tracer_torch" / "scene-cache")
    os.environ.pop("TRACER_NO_SCENE_CACHE", None)
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is false; this benchmark runs on a CUDA "
              "card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import tracer_torch

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         tracer_torch.cuda_device(), root=ROOT, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}, which the port must not load",
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    stages = result.pop("stages")
    print("stages: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr)
    line, notes = last_lines(result)
    print("\n".join(notes), file=sys.stderr)
    print(line)
    return 0


def last_lines(result: dict) -> tuple:
    """(the result's JSON line with ``checks`` last, the lines that end
    standard error: each number compared beside its limit)."""
    result = {k: v for k, v in result.items() if k != "stages"}
    checks = result.pop("checks")
    result["checks"] = checks
    notes = [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    return json.dumps(result), notes


if __name__ == "__main__":
    sys.exit(main())

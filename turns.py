"""What the scripts that time a kernel in turns on one card share
(``b1_turns.py``, ``b2_turns.py``, ``occluded_turns.py``): the card's name
and power limit, loading another checkout's kernel wrapper, the build log's
resource lines, and the per-name summary and JSON file of the turns.

A module beside ``chip_smoke.py`` (it uses the smoke's ``log``). Imports
nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
from pathlib import Path

from chip_smoke import log


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def load_wrapper(name: str, root: Path, module: str, source: str):
    """The wrapper module ``tracer_torch/kernels/<module>.py`` of the
    checkout at ``root``, with its kernel built from ``root``'s
    ``tracer_torch/csrc/<source>`` (and headers, where it names some); it
    shares this checkout's build code."""
    csrc = root / "tracer_torch" / "csrc"
    spec = importlib.util.spec_from_file_location(
        f"{name}_{module}", root / "tracer_torch" / "kernels" / f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = csrc / source
    if hasattr(mod, "HEADERS"):
        mod.HEADERS = tuple(csrc / h.name for h in mod.HEADERS)
    return mod


def log_build(name: str, build_log: str) -> None:
    """The compiler's register, spill and shared-memory lines of a build."""
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build {name}] {line.strip()}")


def check_names(script: str, turns, names) -> None:
    """Raises unless every turn names a kernel or route the script has."""
    unknown = set(turns) - set(names)
    if unknown:
        raise ValueError(f"{script}: no kernel or route named {sorted(unknown)}")


def write_turns(rows, keys, out: Path, smi: str) -> None:
    """Logs each name's values of ``keys`` over its turns, in turn order,
    and writes the card, the turns and that summary as JSON to ``out``."""
    summary = {name: {k: [r[k] for r in rows if r["name"] == name] for k in keys}
               for name in dict.fromkeys(r["name"] for r in rows)}
    for name, vals in summary.items():
        log(f"[summary] {name}: " + ", ".join(
            f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in vals.items()))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "turns": rows, "summary": summary}, indent=1))

"""Compile native sources of the port into shared libraries, at first use.

Outputs go to ``build/tracer_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the compiler command and the source
text, so an edited source or flag rebuilds and an unchanged one loads the
existing library. A library is compiled to a temporary name and renamed
into place, so concurrent processes (pytest workers) never load a
half-written file. Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "tracer_torch"


def shared_library(name: str, command: list[str], sources: list[Path],
                   timeout: float = 600.0) -> tuple[Path, str]:
    """Build ``lib<name>-<hash>.so`` from ``sources`` with ``command``
    (compiler and flags, without ``-o`` or inputs). Returns the library
    path and the compiler's output ("" when the library already existed).
    Raises ``RuntimeError`` with the compiler's output when it fails."""
    h = hashlib.sha256("\0".join(command).encode())
    for src in sources:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [*command, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True, timeout=timeout,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {out.name} failed (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)
    return out, log

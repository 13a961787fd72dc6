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
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "tracer_torch"
CSRC = REPO_ROOT / "tracer_torch" / "csrc"

# Every CUDA kernel of the port: Hopper only, no FMA contraction (so each
# kernel rounds like its op-by-op PyTorch twin), a plain C interface in a
# shared library, and ptxas's register and shared-memory report.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_command() -> list[str]:
    """``nvcc`` (from ``CUDA_HOME`` or ``PATH``) and ``NVCC_FLAGS``."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = None
    if CUDA_HOME is not None and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        found = os.path.join(CUDA_HOME, "bin", "nvcc")
    found = found or shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return [found, *NVCC_FLAGS]


def shared_library(name: str, command: list[str], sources: list[Path],
                   timeout: float = 600.0,
                   headers: tuple[Path, ...] = ()) -> tuple[Path, str]:
    """Build ``lib<name>-<hash>.so`` from ``sources`` with ``command``
    (compiler and flags, without ``-o`` or inputs). ``headers`` are the
    files the sources include: they are hashed, not compiled. Returns the
    library path and the compiler's output ("" when the library already
    existed). Raises ``RuntimeError`` with the compiler's output when it
    fails."""
    h = hashlib.sha256("\0".join(command).encode())
    for src in (*sources, *headers):
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

"""The backend probe (port of ``tracer.util.BackendError`` and
``self_test``): a missing or unusable card surfaces as one clear sentence
before any work, not as a traceback from the middle of the first frame
(the reference's adapter-probe panic, ``src/gpu_handles.rs:72-92``)."""

from __future__ import annotations

import torch


class BackendError(RuntimeError):
    """Raised by :func:`self_test` when no usable CUDA device is present."""


def self_test(device=None) -> tuple[torch.device, str]:
    """Probe the card: CUDA present, the device named, one tiny op run on
    it and read back. Returns (device, one-line description); raises
    :class:`BackendError` otherwise. ``device`` defaults to the current
    CUDA device."""
    if not torch.cuda.is_available():
        raise BackendError(
            f"tracer_torch: no CUDA device is visible to PyTorch (torch {torch.__version__}, "
            f"built for CUDA {torch.version.cuda}); pass --device cpu to render on the CPU.")
    dev = torch.device("cuda") if device is None else torch.device(device)
    try:
        name = torch.cuda.get_device_name(dev)
        out = torch.full((), 1.5, dtype=torch.float32, device=dev) * 2.0 + 1.0
        ok = float(out) == 4.0
    except RuntimeError as e:
        raise BackendError(
            f"tracer_torch: CUDA device {dev} is visible but failed a one-element op "
            f"({type(e).__name__}: {e}).") from e
    if not ok:
        raise BackendError(f"tracer_torch: CUDA device {dev} computed 1.5 * 2 + 1 = {float(out)}.")
    return dev, f"cuda x{torch.cuda.device_count()} ({name})"

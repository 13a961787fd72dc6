"""tracer_torch — the PyTorch + CUDA port of ``tracer`` for NVIDIA Hopper.

The module layout mirrors ``tracer/`` one for one, so each module's JAX
counterpart sits at the same relative path. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA C++ kernel
under ``tracer_torch/csrc`` with a plain-PyTorch twin in the same Python
module (the twin serves CPU tensors and is the reference the kernel is held
against on the card).

Conventions: every function that creates tensors takes an explicit
``device``; nothing picks a device silently. Arithmetic is fp32 throughout
and TF32 is switched off below, so a float32 matmul or convolution on the
card rounds like the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def cuda_device() -> torch.device:
    """The CUDA device; raises ``RuntimeError`` when PyTorch finds none.

    Never falls back to the CPU: a caller that wants the CPU passes
    ``device="cpu"`` explicitly.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tracer_torch: no CUDA device visible to PyTorch "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    return torch.device("cuda")

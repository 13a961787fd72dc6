"""Process-group bring-up (counterpart of ``tracer.parallel.distributed``).

The JAX package calls ``jax.distributed.initialize`` from its environment
triplet. Here the group is ``torch.distributed``'s, from ``torchrun``'s
variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); the JAX triplet (``JAX_COORDINATOR_ADDRESS`` as
``host:port``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) stands in for
them where they are unset. The caller names the device: NCCL for CUDA
tensors (one rank per card, ``cuda:LOCAL_RANK``), gloo for CPU tensors.
Every group has a timeout, so a rank that dies fails the others' next
collective instead of hanging them. A run without the variables is a
single process: ``initialize_from_env`` is a no-op unless asked for a
one-rank group, which then needs no rendezvous at all (an in-process
store).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=120)
DEFAULT_PORT = 29500


def backend_for(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _env() -> dict:
    """torchrun's variables, filled in from the JAX triplet where unset."""
    env = os.environ
    out = {k: env[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                               "MASTER_PORT") if env.get(k)}
    if "WORLD_SIZE" not in out and env.get("JAX_NUM_PROCESSES"):
        out["WORLD_SIZE"] = env["JAX_NUM_PROCESSES"]
    if "RANK" not in out and env.get("JAX_PROCESS_ID"):
        out["RANK"] = env["JAX_PROCESS_ID"]
    coord = env.get("JAX_COORDINATOR_ADDRESS")
    if coord and "MASTER_ADDR" not in out:
        host, _, port = coord.rpartition(":")
        out["MASTER_ADDR"], out["MASTER_PORT"] = host, port
    return out


def local_device(device) -> torch.device:
    """This rank's device of ``device``'s type: ``cuda:LOCAL_RANK`` for the
    card, the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize_from_env(device, one_rank: bool = False) -> bool:
    """Join the process group that the environment describes, with the
    backend for ``device``. Without the variables: nothing (returns False),
    or, when ``one_rank``, a group of this process alone. Returns True when
    a group is up. Safe to call more than once. Raises when the variables
    are set and the rendezvous cannot be reached within ``TIMEOUT``."""
    if dist.is_initialized():
        return True
    env = _env()
    if not env.get("WORLD_SIZE") and not env.get("MASTER_ADDR"):
        if not one_rank:
            return False
        dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
        return True
    host = env.get("MASTER_ADDR", "127.0.0.1")
    port = env.get("MASTER_PORT", str(DEFAULT_PORT))
    dist.init_process_group(backend_for(device), init_method=f"tcp://{host}:{port}",
                            rank=int(env.get("RANK", "0")),
                            world_size=int(env.get("WORLD_SIZE", "1")), timeout=TIMEOUT)
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()

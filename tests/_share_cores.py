"""CPU threads for the port's tests.

pytest-xdist runs several test processes at once. PyTorch's OpenMP pool
has one spin-waiting thread per core in each of them, so two processes
doing heavy tensor work at the same time oversubscribe the cores and stall
each other for minutes (each alone takes well under a minute). The port's
test modules call ``share_cores()`` when imported: under xdist each worker
keeps its share of the cores, and a run without xdist keeps them all.
"""

from __future__ import annotations

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))

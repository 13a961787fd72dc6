"""``launches_per_step``: kernels the device ran per traced step (copies and
sets left out), from the profiler's trace."""

from benchmark.metrics import _device


def read(probe):
    return _device.launches(probe) if probe.unit == "step" else None

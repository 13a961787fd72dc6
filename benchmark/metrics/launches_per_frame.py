"""``launches_per_frame``: kernels the device ran per traced frame (copies and
sets left out), from the profiler's trace."""

from benchmark.metrics import _device


def read(probe):
    return _device.launches(probe) if probe.unit == "frame" else None

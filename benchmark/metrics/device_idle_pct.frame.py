"""``device_idle_pct.frame``: the share of the traced window in which no
kernel, copy or set ran on the device: 100 (1 - busy / window), busy the
union of the device intervals."""

from benchmark.metrics import _device


def read(probe):
    return _device.idle_pct(probe) if probe.unit == "frame" else None

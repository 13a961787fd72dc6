"""Shared arithmetic of the readers that take device time from the trace."""


def per_unit_ms(probe, key: str):
    """Device ms per traced frame or step of the kernels whose name holds
    ``key``; None where no such kernel ran or nothing was traced."""
    if not probe.trace.units:
        return None
    us = probe.trace.device_us(key)
    return us / 1e3 / probe.trace.units if us > 0 else None


def launches(probe):
    if not probe.trace.units or not probe.trace.device:
        return None
    return len(probe.trace.kernels()) / probe.trace.units


def idle_pct(probe):
    w = probe.trace.window_us
    if w <= 0 or not probe.trace.device:
        return None
    return 100.0 * (1.0 - probe.trace.busy_us() / w)

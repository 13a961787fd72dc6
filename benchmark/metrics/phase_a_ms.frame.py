"""``phase_a_ms.frame``: host-clock ms per frame inside packet phase A
(``accel.packet._phase_a_chunk``), over the traced run's untraced window.
Phase A ends on a host read of its loop condition, so the host clock
brackets its device work too."""

NAME = "phase_a"


def install(probe):
    from tracer_torch.accel import packet

    probe.wrap(packet, "_phase_a_chunk", probe.host_timed(NAME))


def read(probe):
    ms = probe.host_ms.get(NAME)
    return ms / probe.host_units if ms and probe.host_units else None

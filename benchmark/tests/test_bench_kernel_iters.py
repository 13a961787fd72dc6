"""The reader of ``phase_a_kernel_iters_per_frame`` beside the reader of the
walk's iterations, ``phase_a_iters_per_frame``, on counters set by hand."""

from benchmark import harness


def test_kernel_iterations_read_per_frame_beside_the_walks_iterations():
    """``phase_a_kernel_iters_per_frame`` reads ``packet.phase_a_kernel_iterations``
    counted since ``install``, per frame of both windows, as
    ``phase_a_iters_per_frame`` reads the walk's iterations: where every
    iteration runs the walk kernel the two are equal. Where the program
    counts none (CPU tensors, or a program without the kernel) it reads
    None."""
    from tracer_torch import obs
    from tracer_torch.accel import packet

    kernel, iters = (harness.load_reader(n) for n in ("phase_a_kernel_iters_per_frame",
                                                      "phase_a_iters_per_frame"))
    probe = harness.Probe("frame")
    obs.count("packet.phase_a_kernel_iterations", 5)  # before install: not read
    try:
        kernel.install(probe)
        iters.install(probe)
        probe.host_units = 2
        obs.count("packet.phase_a_iterations", 8)
        assert iters.read(probe) == 4.0 and kernel.read(probe) is None
        probe.trace.units = 1
        for n in (packet.CHECK_EVERY, packet.CHECK_EVERY, 1):
            obs.count("packet.phase_a_iterations", n)
            obs.count("packet.phase_a_kernel_iterations", n)
        assert kernel.read(probe) == (2 * packet.CHECK_EVERY + 1) / 3
        assert iters.read(probe) == (8 + 2 * packet.CHECK_EVERY + 1) / 3
    finally:
        probe.unwrap()
        obs.reset()

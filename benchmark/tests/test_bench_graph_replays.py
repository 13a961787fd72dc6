"""The reader of ``phase_a_graph_replays_per_frame`` beside the reader of the
walk's iterations, ``phase_a_iters_per_frame``, on counters set by hand."""

from benchmark import harness


def test_graph_replays_read_per_frame_beside_the_walks_iterations():
    """``phase_a_graph_replays_per_frame`` reads ``packet.phase_a_graph_replays``
    counted since ``install``, per frame of both windows, as
    ``phase_a_iters_per_frame`` reads the walk's iterations: one replay per
    ``CHECK_EVERY`` iterations where the walk replays its graph. Where the
    program counts no replay (CPU tensors, or a program without the graph)
    it reads None."""
    from tracer_torch import obs
    from tracer_torch.accel import packet

    replays, iters = (harness.load_reader(n) for n in ("phase_a_graph_replays_per_frame",
                                                       "phase_a_iters_per_frame"))
    probe = harness.Probe("frame")
    obs.count("packet.phase_a_graph_replays", 3)  # before install: not read
    try:
        replays.install(probe)
        iters.install(probe)
        probe.host_units = 2
        obs.count("packet.phase_a_iterations", 8)
        assert iters.read(probe) == 4.0 and replays.read(probe) is None
        probe.trace.units = 1
        for _ in range(6):
            obs.count("packet.phase_a_iterations", packet.CHECK_EVERY)
            obs.count("packet.phase_a_graph_replays")
        assert replays.read(probe) == 2.0
        assert iters.read(probe) == (8 + 6 * packet.CHECK_EVERY) / 3
    finally:
        probe.unwrap()
        obs.reset()

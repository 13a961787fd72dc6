"""The reader of ``brute_kernel_pairs_per_frame`` beside the reader of the
brute-force engine's pairs, ``brute_pairs_per_frame``, on counters set by
hand."""

from benchmark import harness


def test_kernel_pairs_read_per_frame_beside_the_engines_pairs():
    """``brute_kernel_pairs_per_frame`` reads ``brute.kernel_pairs`` counted
    since ``install``, per frame of both windows, as
    ``brute_pairs_per_frame`` reads ``brute.pairs``: where every query runs
    the kernel the two are equal. Where the program counts none (CPU
    tensors, or a program without the kernel) it reads None."""
    from tracer_torch import obs

    kernel, pairs = (harness.load_reader(n) for n in ("brute_kernel_pairs_per_frame",
                                                      "brute_pairs_per_frame"))
    probe = harness.Probe("frame")
    obs.count("brute.kernel_pairs", 7)  # before install: not read
    try:
        kernel.install(probe)
        pairs.install(probe)
        probe.host_units = 2
        obs.count("brute.pairs", 12 * 100)
        assert pairs.read(probe) == 600.0 and kernel.read(probe) is None
        probe.trace.units = 1
        for n in (12 * 4096, 12 * 4096, 12 * 17):
            obs.count("brute.pairs", n)
            obs.count("brute.kernel_pairs", n)
        assert kernel.read(probe) == 12 * (2 * 4096 + 17) / 3
        assert pairs.read(probe) == 12 * (100 + 2 * 4096 + 17) / 3
    finally:
        probe.unwrap()
        obs.reset()

"""The metric arithmetic on synthetic data: the window's rate and p95,
the idle share and breakdown of a synthetic trace, the roofline's least
time and the per-layer readers."""

import types

import pytest
import torch

from benchmark import harness, trace as tr
from benchmark.counts import b1, peaks


def cell(unit="frame"):
    loop = {"frame": "frames", "step": "grad_steps"}[unit]
    e2e = [{"name": f"{unit}_ms", "unit": "ms"}, {"name": f"{unit}_p95_ms", "unit": "ms"},
           {"name": "setup_s", "unit": "s"}]
    return harness.Cell("x", {}, {"loop": loop}, e2e, [])


def test_window_rate_and_p95():
    times = [0.010] * 19 + [0.030]
    out = harness.end_to_end(cell(), times, 7.5)
    assert out["frame_ms"]["value"] == pytest.approx(sum(times) / 20 * 1e3)
    assert out["frame_p95_ms"]["value"] == pytest.approx(10.0)  # rank ceil(0.95 * 20) = 19
    assert out["setup_s"] == {"value": 7.5, "unit": "s"}
    times = [0.010] * 18 + [0.030, 0.040]
    assert harness.end_to_end(cell(), times, 1.0)["frame_p95_ms"]["value"] == pytest.approx(30.0)
    out = harness.end_to_end(cell("step"), [0.02, 0.04], 1.0)
    assert out["step_ms"]["value"] == pytest.approx(30.0)


def synthetic_trace():
    t = tr.Trace(window=(0.0, 1000.0), units=2)
    t.device = [("kA", 100.0, 200.0), ("kB", 150.0, 250.0), ("Memcpy HtoD", 400.0, 450.0),
                ("super_hits_kernel", 600.0, 700.0)]
    t.spans = [("frame", 0.0, 500.0), ("frame", 500.0, 1000.0)]
    t.ops = [("aten::nonzero", 260.0, 390.0)]
    return t


def test_busy_idle_and_breakdown():
    t = synthetic_trace()
    assert t.busy_intervals() == [[100.0, 250.0], [400.0, 450.0], [600.0, 700.0]]
    assert t.busy_us() == 300.0
    assert len(t.kernels()) == 3
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("kA", "kB", "super_hits_kernel")
    gaps = bd["idle_gaps"]
    assert gaps[0] == ["frame", 300e-6]  # 700..1000
    assert ["frame/aten::nonzero", 150e-6] in gaps  # 250..400
    probe = harness.Probe("frame")
    probe.trace = t
    idle = harness.load_reader("device_idle_pct.frame").read(probe)
    assert idle == pytest.approx(70.0)
    assert harness.load_reader("launches_per_frame").read(probe) == pytest.approx(1.5)
    assert harness.load_reader("b1_ms.frame").read(probe) == pytest.approx(0.05)
    assert harness.load_reader("launches_per_step").read(probe) is None
    assert harness.load_reader("b3_ms.frame").read(probe) is None


def test_least_time():
    ms, by = peaks.least_ms(3.35e9, 1.0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = peaks.least_ms(1.0, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_b1_count_on_a_hand_case():
    """One super-tile, one quarter block holding one triangle in front of
    every ray: every lane is live at the first slot and tests TQ columns;
    the second slot is past every lane's hit, so it is not visited."""
    TQ = 4
    blk = torch.zeros((2, 16, TQ))
    for q in range(2):
        # v0 = (-1, -1, 1), e0 = (4, 0, 0), e1 = (0, 4, 0); n = e0 x e1 = (0, 0, 16)
        v0 = torch.tensor([-1.0, -1, 1])
        e0, e1 = torch.tensor([4.0, 0, 0]), torch.tensor([0.0, 4, 0])
        n = torch.linalg.cross(e0, e1)
        blk[q, 0:3, 0] = v0
        blk[q, 3:6, 0] = e0  # gamma = -(nom . e0) / denom
        blk[q, 6:9, 0] = e1  # beta = (nom . e1) / denom
        blk[q, 9, 0] = 7.0
        blk[q, 10, 0] = 1.0
        blk[q, 11:14, 0] = n
        blk[q, 14, 0] = float(n @ v0)
    S = 2048
    o = torch.zeros((1, S, 3))
    d = torch.tensor([0.0, 0.0, 1.0]).expand(1, S, 3).contiguous()
    tmin = torch.zeros((1, S))
    bt = torch.full((1, S), 3.0e38)
    bp = torch.full((1, S), -1.0)
    args = (blk, torch.tensor([[0, 1]]), torch.tensor([[0.5, 2.0]]), torch.tensor([2]),
            torch.tensor([[0xFFFF, 0xFFFF]]), o, d, tmin, bt, bp, False)
    assert b1.live_tests(*args) == S * TQ
    ms = b1.least_ms(*args)
    n_bytes = 2 * 16 * TQ * 4 + sum(t.numel() * t.element_size() for t in args[1:10]) \
        + bt.numel() * 4 * 2
    assert ms == pytest.approx(max(n_bytes / peaks.HBM_BYTES_PER_S,
                                   S * TQ * b1.OPS_PER_TEST / peaks.FP32_OPS_PER_S) * 1e3)


def test_roofline_reader():
    t = synthetic_trace()
    probe = harness.Probe("frame")
    probe.trace = t
    probe.captured = {"b1_calls": [], "b1_frame": 1}
    rd = harness.load_reader("b1_roofline_pct")
    assert rd.read(probe) is None  # nothing caught: no reading
    probe.captured["b1_calls"] = [("call",)]
    rd.b1 = types.SimpleNamespace(least_ms=lambda *a: 0.025)
    assert rd.read(probe) == pytest.approx(25.0)  # 0.025 ms over the 0.1 ms in frame 1

"""``cornell_path.frames`` on the CPU at 16x16: the run against its plain
reference (``reference/path_area_frames.py``), the TF32 control, the
generic frame faults and the cell's own (``cornell_faults.py``), and the
new per-layer readers, with the program's spans and without them."""

import os
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import cornell_faults, faults
from benchmark.tests.tiny import ROOT

NAME = "cornell_path.frames"
OVERRIDES = {"config": {"width": 16, "height": 16}, "traffic": {"check": {"lanes": 256}}}
NEW = ("brute_self_ms.frame", "brute_launches_per_frame", "brute_pairs_per_frame",
       "nee_self_ms.frame", "dielectric_self_ms.frame")
SPANS = ("brute.closest", "brute.occluded", "integrator.nee", "integrator.dielectric")


def run(seed: int = 2_500_000_123, seconds: float = 0.5, trace: bool = False, keep=None):
    os.environ["TRACER_NO_SCENE_CACHE"] = "1"
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    return harness.run(NAME, seed, seconds, trace, "cpu", root=ROOT,
                       t_start=time.perf_counter(), overrides=OVERRIDES, keep=keep)


def test_run_is_correct_against_its_reference():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    assert res["checks"]["err_p50"]["value"] < 1e-6


def test_tf32_control_fails_the_check():
    keep = {}
    assert run(seed=2_600_000_017, keep=keep)["correct"]
    ok, checks, _ = harness.control(keep, torch.device("cpu"))
    assert not ok, checks


FAULTS = faults.FRAME + cornell_faults.CORNELL


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch.setattr)
    # Two seconds: the spheres' shadows reach few pixels in the first frames
    # (3-5 frames read ``bad_share`` 0.03-0.07 against the limit 0.03), so
    # a loaded machine's short window must not decide the test.
    res = run(seed=2_700_000_031, seconds=2.0)
    assert not res["correct"], res["checks"]


def test_faults_register_by_name():
    class Module:
        pass

    cornell_faults.register(Module)
    assert all(getattr(Module, f.__name__) is f for f in cornell_faults.CORNELL)


def test_traced_run_reads_the_new_metrics():
    res = run(trace=True)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("brute_self_ms.frame", "nee_self_ms.frame", "dielectric_self_ms.frame",
                 "shade_self_ms.frame", "bounces_per_frame", "host_reads_per_frame"):
        assert m[name] > 0, name
    # Two queries a bounce (the closest hit, the shadow ray), each of every
    # lane against the 12 triangles.
    assert m["brute_pairs_per_frame"] == 2 * m["bounces_per_frame"] * 16 * 16 * 12
    # No device on the CPU: no launches are read.
    assert "brute_launches_per_frame" not in m and "launches_per_frame" not in m


def test_new_readers_say_nothing_without_the_spans(monkeypatch):
    """A program whose ``obs`` lacks the new spans and counter, as the
    parent's does: the new readers return None, the others still read."""
    from tracer_torch import obs

    span, count = obs.span, obs.count
    monkeypatch.setattr(obs, "span", lambda name: obs._NOOP if name in SPANS else span(name))
    monkeypatch.setattr(obs, "count",
                        lambda name, n=1: None if name == "brute.pairs" else count(name, n))
    res = run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert not set(NEW) & set(m), m
    assert m["bounces_per_frame"]["value"] > 0 and m["shade_self_ms.frame"]["value"] > 0


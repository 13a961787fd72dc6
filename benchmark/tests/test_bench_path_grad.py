"""``bunny_path.grad`` on the CPU at 16x16: the run against its plain
reference (``reference/path_env_grad.py``), the TF32 control, the generic
gradient faults and the cell's own (``path_grad_faults.py``), the new
per-layer readers with the program's spans and counters and without them,
B2's frozen bound (``counts/b2.py``) and the cell's entries in
``BENCHMARK.json``.

``origins_detached`` is left out of the faults here: at 16x16 no continued
path of the bunny's stand-in hits it again, so the origins carry no
gradient at this size. It fails the tier-1 comparison on a concave mesh
(``tests/test_torch_path_env_grad.py``) and the cell's at its own size."""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.counts import b2, peaks
from benchmark.tests import faults, path_grad_faults, tiny
from benchmark.tests.tiny import ROOT

NAME = "bunny_path.grad"
SIZE = 16
OVERRIDES = {"config": {"width": SIZE, "height": SIZE}}
NEW = ("b2_rows_per_step", "b2_roofline_pct.step", "place_self_ms.step", "held_gib.step")
STEP = ("launches_per_step", "device_idle_pct.step", "b2_ms.step", "peak_gib.step",
        "host_reads_per_step", "grad_forward_ms.step", "grad_backward_ms.step",
        "backward_launches_per_step")


def run(name: str = NAME, seed: int = 2_500_000_123, seconds: float = 0.5, trace: bool = False,
        keep=None, overrides=None):
    os.environ["TRACER_NO_SCENE_CACHE"] = "1"
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    return harness.run(name, seed, seconds, trace, "cpu", root=ROOT, t_start=time.perf_counter(),
                       overrides=OVERRIDES if overrides is None else overrides, keep=keep)


def test_run_is_correct_against_its_reference():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"step_ms", "setup_s"}
    assert res["checks"]["grad_err"]["value"] < 1e-4


def test_tf32_control_fails_the_check():
    keep = {}
    assert run(seed=2_600_000_017, keep=keep)["correct"]
    ok, checks, _ = harness.control(keep, torch.device("cpu"))
    assert not ok, checks


FAULTS = faults.GRAD + (path_grad_faults.env_grad_dropped,
                        path_grad_faults.roulette_prob_detached)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch.setattr)
    res = run(seed=2_700_000_031)
    assert not res["correct"], res["checks"]


def test_faults_register_by_name():
    class Module:
        pass

    path_grad_faults.register(Module)
    assert all(getattr(Module, f.__name__) is f for f in path_grad_faults.PATH_GRAD)


def _placements(monkeypatch) -> list:
    """The (rows, V) of every call of B2's CPU twin from now on."""
    from tracer_torch.kernels import scatter_vn

    calls, twin = [], scatter_vn.segment_place_reference

    def spy(sids, svals, V):
        calls.append((sids.shape[0], V))
        return twin(sids, svals, V)

    monkeypatch.setattr(scatter_vn, "segment_place_reference", spy)
    return calls


@pytest.mark.parametrize("name", ["dragon.grad", NAME])
def test_traced_run_reads_the_new_metrics(name, monkeypatch):
    calls = _placements(monkeypatch)
    keep = {}
    res = run(name, trace=True, keep=keep, overrides=tiny.OVERRIDES.get(name, OVERRIDES))
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # The warm-up step's placements come before the readers count.
    steps = keep["units"]
    per_step = sum(r for r, _ in calls) / (steps + 1)
    assert m["b2_rows_per_step"] == per_step > 0
    assert m["place_self_ms.step"] > 0
    assert m["held_gib.step"] == 0.0  # no allocator counters off the card
    # No device on the CPU: nothing is traced on it.
    assert "b2_roofline_pct.step" not in m and "b2_ms.step" not in m
    assert m["grad_backward_ms.step"] > 0


def test_new_readers_say_nothing_without_the_spans(monkeypatch):
    """A program whose ``obs`` lacks the new span and counters, as the
    parent's does: the new readers return None, the others still read."""
    from tracer_torch import obs

    span, count = obs.span, obs.count
    monkeypatch.setattr(obs, "span", lambda name: obs._NOOP if name == "grad.place"
                        else span(name))
    monkeypatch.setattr(obs, "count", lambda name, n=1: None if name in (
        "scatter_vn.rows", "scatter_vn.out_rows", "grad.held_bytes") else count(name, n))
    res = run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert not set(NEW) & set(m), m
    assert m["grad_forward_ms.step"]["value"] > 0 and m["host_reads_per_step"]["value"] > 0


def test_b2_bound_is_the_bytes_of_its_rows():
    rows, V = 786_432, 34_969
    want = (rows * (4 + 24) + V * 24) / peaks.HBM_BYTES_PER_S * 1e3
    assert b2.least_ms(rows, V) == pytest.approx(want, rel=1e-12)
    # Bytes bound every call, so two calls' least times add up.
    assert b2.least_ms(2 * rows, 2 * V) == pytest.approx(2 * b2.least_ms(rows, V), rel=1e-12)


def test_b2_roofline_reads_the_counters_against_the_kernels_time():
    rd = harness.load_reader("b2_roofline_pct.step")
    from benchmark.metrics import _program

    counters = {"scatter_vn.rows": 6 * 786_432, "scatter_vn.out_rows": 6 * 34_969}
    obs = SimpleNamespace(counters=lambda: counters)
    trace = SimpleNamespace(units=2, device_us=lambda key: 2 * 40.0 if key == "_sums_kernel"
                            else 0.0)
    probe = SimpleNamespace(captured={_program.KEY: {"obs": obs, "counters": {}}},
                            host_units=4, trace=trace)
    got = rd.read(probe)
    assert got == pytest.approx(100.0 * b2.least_ms(786_432, 34_969) / 0.040)
    assert 0 < got <= 100
    probe.captured[_program.KEY] = None
    assert rd.read(probe) is None



def test_configuration_is_the_w9e1_row_differentiated():
    """``bunny_path_grad`` holds ``bunny_path``'s row, size, stand-in and
    cuts unchanged; it adds the gradient it is run for, under a name and
    source of its own."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    confs = {c["name"]: c for c in m["configs"]}
    grad, frames = confs["bunny_path_grad"], confs["bunny_path"]
    assert grad["reduced"] == frames["reduced"] and grad["source"] != frames["source"]
    g = json.loads((ROOT / grad["file"]).read_text())
    f = json.loads((ROOT / frames["file"]).read_text())
    assert set(g) - set(f) == {"gradient"} and set(f) <= set(g)
    assert {k: v for k, v in g.items() if k not in ("name", "source", "gradient")} == \
        {k: v for k, v in f.items() if k not in ("name", "source")}
    assert g["gradient"]["leaves"] == ["camera", "vertices", "normals", "material", "env"]

def test_manifest_lists_the_cell():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in m["workloads"] if w["name"] == NAME)
    assert cell["config"] == "bunny_path_grad" and cell["traffic"] == "grad_steps"
    assert cell["chips"] == 1
    traffic = json.loads((ROOT / "benchmark" / "workloads" / f"{NAME}.json").read_text())
    assert traffic["loop"] == "grad_steps" and traffic["reference"] == "path_env_grad"
    assert traffic["grad_cfg"] == {"loop": "scan"} and traffic["trace_units"] == 2
    assert traffic["check"] == {} and set(traffic["limits"]) == {"grad_err"}
    step_ms = next(e for e in m["end_to_end"] if e["name"] == "step_ms")
    assert NAME in step_ms["workloads"]
    per_layer = {e["name"]: e for e in m["per_layer"]}
    for name in STEP:
        assert NAME in per_layer[name]["workloads"], name
    for name in NEW:
        assert per_layer[name]["workloads"] == ["dragon.grad", NAME], name
        assert per_layer[name]["moves"] == "step_ms"
    c = harness.cell(ROOT, NAME)
    assert c.config["width"] == c.config["height"] == 512
    assert c.config["scene"]["max_depth"] == 50

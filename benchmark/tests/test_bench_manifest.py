"""BENCHMARK.json against the benchmark's contract: names, units, files,
and which cells report which metric."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.tiny import ROOT

BENCH = ROOT / "benchmark"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"][1].startswith("benchmark/")
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    metrics = M["end_to_end"] + M["per_layer"]
    names = [x["name"] for x in M["configs"] + M["workloads"]] + [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in M["workloads"]}) == len(M["workloads"])
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace") for m in M["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
               for m in M["per_layer"])
    for w in M["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in M["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_files_found_by_name():
    for c in M["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert set(c["reduced"]) <= set(conf["assumed"]) | {"model", "hdri"}
        assert any(w["config"] == c["name"] for w in M["workloads"])
    for w in M["workloads"]:
        traffic = json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        assert traffic["config"] == w["config"] and traffic["why"] == w["why"]
    for m in M["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for w in M["workloads"]:
        c = harness.cell(ROOT, w["name"])
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in got, (w["name"], m["name"])
    for m in M["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in M["workloads"]}
        assert m["moves"] in e2e
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_cell_files_load(name):
    c = harness.cell(ROOT, name)
    assert (BENCH / "loops" / f"{c.traffic['loop']}.py").exists()
    assert (BENCH / "reference" / f"{c.traffic['reference']}.py").exists()
    assert c.unit in ("frame", "step")
    assert callable(c.loop.prepare) and callable(c.reference.output)
    assert callable(c.reference.numbers)
    assert set(c.traffic["limits"]) >= ({"grad_err"} if c.unit == "step"
                                        else {"bad_share", "frames_missing"})

"""Whole runs of every cell on the CPU at a tiny size: the result's keys,
the plain reference against the port, the TF32 control, the faults the
check must catch (``faults.py``), and what the runs import."""

import ast
import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests import faults, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_run_is_correct_and_its_last_line(name):
    res = tiny.run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    from benchmark import run as entry

    line, notes = entry.last_lines(res)
    out = json.loads(line)
    assert list(out)[-1] == "checks" and set(KEYS) <= set(out)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = harness.cell(tiny.ROOT, name)
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert len(notes) == len(out["checks"]) and all("limit" in n for n in notes)


def test_traced_run_reads_the_host_side_metrics():
    res = tiny.run("bunny_path.frames", trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["build_s"]["value"] > 0 and m["phase_a_ms.frame"]["value"] > 0
    # No device trace on the CPU: the device readers find nothing and say nothing.
    assert "b3_ms.frame" not in m and "device_idle_pct.frame" not in m


@pytest.mark.parametrize("name", tiny.CELLS)
def test_tf32_control_fails_the_check(name):
    keep = {}
    res = tiny.run(name, seed=2_600_000_017, keep=keep)
    assert res["correct"]
    ok, checks, _ = harness.control(keep, torch.device("cpu"))
    assert not ok, checks


# The emission width that makes the tiny shadowed cell's any-hit cull
# overflow, so that its sweep has work (the bunny-sized mesh never
# overflows the program's own width).
SHORT_LIST = 4

FAULTS = [(n, f) for n in ("dragon.frames", "dragon.shadowed", "bunny_path.frames")
          for f in faults.FRAME] + [("dragon.grad", f) for f in faults.GRAD] + [
    ("dragon.shadowed", faults.always_blocked),
    ("dragon.shadowed", functools.partial(faults.skipped_sweep, short_list=SHORT_LIST))]


def _fault_id(name, fault):
    return f"{name}-{getattr(fault, 'func', fault).__name__}"


@pytest.mark.parametrize("name,fault", FAULTS, ids=[_fault_id(n, f) for n, f in FAULTS])
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch.setattr)
    res = tiny.run(name, seed=2_700_000_031)
    assert not res["correct"], res["checks"]


def test_shadowed_run_with_a_short_list_is_correct(monkeypatch):
    """The sound counterpart of the skipped sweep: with the short list the
    sweep decides most blocked rays, and the run is correct."""
    from tracer_torch.kernels import super_occluded

    faults.short_any_hit(monkeypatch.setattr, SHORT_LIST)
    swept = []
    orig = super_occluded.occluded

    def spy(tb, em, max_rounds, counts=None):
        out = orig(tb, em, max_rounds, counts)
        swept.append(int(em.overflow.sum()))
        return out

    monkeypatch.setattr(super_occluded, "occluded", spy)
    res = tiny.run("dragon.shadowed", seed=2_700_000_031)
    assert res["correct"], res["checks"]
    assert swept and all(n > 0 for n in swept)


BENCH = Path(__file__).resolve().parents[1]


def test_reference_imports_nothing_of_the_program():
    for path in list((BENCH / "reference").glob("*.py")) + list((BENCH / "counts").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("tracer_torch", "tracer", "jax", "jaxlib",
                                               "flax"), (path.name, n)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from benchmark.tests import tiny; "
            "from benchmark import harness; tiny.run('dragon.frames'); "
            "print(harness.forbidden_modules())" % str(tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tiny.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    mods = [m.split(".")[0] for m in harness.FORBIDDEN]
    assert "tracer" in mods and "jax" in mods


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "dragon.frames",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=str(tiny.ROOT))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    assert out.returncode != 0 and out.stdout.strip() == ""

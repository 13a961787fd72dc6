"""The texel-cotangent placement's readers (``texel_place_ms.step``,
``texel_place_rows_per_step``) on ``bunny_path.grad`` at 16x16 on the CPU,
with the program's counter and without it (as the parent's program, which
leaves the texel gradient to PyTorch's index backward, has none), the
device reader on a hand-made trace, and their entries in
``BENCHMARK.json``."""

import json
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.metrics import _program
from benchmark.tests.test_bench_path_grad import NAME, run
from benchmark.tests.tiny import ROOT

NEW = ("texel_place_ms.step", "texel_place_rows_per_step")


def test_traced_run_reads_the_rows_of_every_lookup(monkeypatch):
    from tracer_torch.kernels import texel_place

    calls, twin = [], texel_place.place_reference

    def spy(sids, rows, n):
        calls.append((sids.shape[0], n))
        return twin(sids, rows, n)

    monkeypatch.setattr(texel_place, "place_reference", spy)
    keep = {}
    res = run(trace=True, keep=keep)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # The warm-up step's placements come before the readers count.
    per_step = sum(r for r, _ in calls) / (keep["units"] + 1)
    assert m["texel_place_rows_per_step"] == per_step > 0
    # Four taps a lane of the 16x16 frame, each lookup onto the 32x64 map.
    assert all(r == 4 * 16 * 16 and n == 32 * 64 for r, n in calls)
    # No device on the CPU: nothing is traced on it.
    assert "texel_place_ms.step" not in m


def test_new_readers_say_nothing_without_the_counter(monkeypatch):
    from tracer_torch import obs

    count = obs.count
    monkeypatch.setattr(obs, "count", lambda name, n=1: None if name.startswith("texel_place.")
                        else count(name, n))
    res = run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert not set(NEW) & set(m), m
    assert m["b2_rows_per_step"]["value"] > 0


def _probe(device_us):
    trace = SimpleNamespace(units=2, device_us=device_us)
    return SimpleNamespace(captured={_program.KEY: None}, host_units=4, trace=trace)


def test_device_reader_takes_the_texel_kernels_alone():
    names = {"void (anonymous namespace)::texel_place_chunk_kernel<256>(int const*)": 300.0,
             "(anonymous namespace)::texel_place_span_kernel(int const*)": 100.0,
             "void (anonymous namespace)::chunk_sums_kernel<256>(int const*)": 50.0,
             "(anonymous namespace)::span_sums_kernel(int const*)": 30.0,
             "void at::native::indexing_backward_kernel_small_stride": 9000.0}
    device_us = lambda key: sum(us for n, us in names.items() if key in n)
    texel = harness.load_reader("texel_place_ms.step").read(_probe(device_us))
    assert texel == pytest.approx((300.0 + 100.0) / 1e3 / 2)
    # B2's reader keeps reading the vertex placement alone.
    assert harness.load_reader("b2_ms.step").read(_probe(device_us)) == \
        pytest.approx((50.0 + 30.0) / 1e3 / 2)
    assert harness.load_reader("texel_place_ms.step").read(_probe(lambda key: 0.0)) is None


def test_manifest_lists_the_new_metrics():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {e["name"]: e for e in m["per_layer"]}
    for name in NEW:
        e = per_layer[name]
        assert e["workloads"] == [NAME] and e["moves"] == "step_ms"
        assert e["layer"] == "kernels.texel_place"
    assert per_layer["texel_place_ms.step"]["source"] == "device_trace"
    assert per_layer["texel_place_rows_per_step"]["source"] == "program_counter"
    assert [e["name"] for e in m["per_layer"][-2:]] == list(NEW)

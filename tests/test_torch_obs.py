"""The port's spans and counters (``tracer_torch.obs``) on the CPU.

* Self time over nested spans on a scripted clock; a span opened on
  another thread leaves the main thread's stack and self time alone.
* Off, a span is a shared no-op context that costs well under a
  microsecond; ``host_read`` is ``bool`` and counts its site.
* On ``W9 E1 Bunny`` at 16x16 (path mode, the packet engine, the bounce
  loop): ``integrator.bounces`` equals the loop's bounces, and each
  ``host_read.*`` counter equals the reads its site made.
* ``packet.phase_a_kernel_iterations`` equals ``packet.phase_a_iterations``
  on the card and is absent on the CPU (the card's case skips here).
* Frames (path, direct, shadowed) and a gradient step are bitwise equal
  with spans on and off.
* On ``W8 E3 Absorption`` at 16x16 (the brute-force engine, area-light
  NEE, the dielectric): the engine's and the shading's spans open,
  ``brute.pairs`` equals rays times triangles over the engine's calls, and
  the frame is bitwise equal with spans on and off; the bunny's path frame
  and the dragon's direct frame open none of those spans.
* Under a CPU ``torch.profiler``, spans off leave no ``tracer_torch:``
  event and spans on leave the layers' names; ``cli --profile`` writes
  them into its trace.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import pytest
import torch
from _share_cores import share_cores

from chip_smoke import seeded_env, with_fixture_model, with_seeded_env, with_standin_mesh
from tracer_torch import cli, obs
from tracer_torch.accel import packet
from tracer_torch.kernels import intersect
from tracer_torch.diff import grad as G
from tracer_torch.render import integrator, progressive, texture
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

SIZE = 16


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    obs.enabled(False)
    yield
    obs.enabled(False)
    obs.reset()


def _small(desc):
    return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=SIZE, height=SIZE))


@pytest.fixture(scope="module")
def bunny():
    scene, cfg = build_scene(_small(get_scene("W9 E1 Bunny")), "cpu")
    env = texture.TextureBuf(data=torch.as_tensor(seeded_env(False)), kind=texture.ENV_LDR)
    return dataclasses.replace(scene, env=env), cfg


@pytest.fixture(scope="module")
def dragon():
    """``Project: Dragon`` on the bunny's stand-in: the flat engine."""
    return build_scene(_small(with_standin_mesh(get_scene("Project: Dragon"), "bunny.obj")),
                       "cpu")


@pytest.fixture(scope="module")
def cornell():
    """``W8 E3 Absorption`` on the fixture box: 12 triangles, two spheres."""
    return build_scene(_small(with_fixture_model(get_scene("W8 E3 Absorption"))), "cpu")


CORNELL_SPANS = {"brute.closest", "brute.occluded", "integrator.nee", "integrator.dielectric"}


def test_self_time_over_nested_spans(monkeypatch):
    clock = iter([0, 10, 30, 35, 60, 70, 80, 100])
    monkeypatch.setattr(obs.time, "perf_counter_ns", lambda: next(clock) * 1_000_000)
    obs.enabled(True)
    with obs.span("outer"):  # 0 .. 100
        with obs.span("mid"):  # 10 .. 60
            with obs.span("inner"):  # 30 .. 35
                pass
        with obs.span("inner"):  # 70 .. 80
            pass
    t = obs.totals()
    assert t["inner"] == obs.Totals(2, 15.0, 15.0)
    assert t["mid"] == obs.Totals(1, 50.0, 45.0)
    assert t["outer"] == obs.Totals(1, 100.0, 40.0)


def test_a_span_on_another_thread_leaves_the_main_stack_alone():
    obs.enabled(True)
    done = threading.Event()

    def backward():
        with obs.span("worker"):
            time.sleep(0.02)
        done.set()

    with obs.span("main"):
        th = threading.Thread(target=backward)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive() and done.is_set()
        with obs.span("child"):
            pass
    t = obs.totals()
    assert t["worker"].calls == 1 and t["worker"].total_ms >= 20.0
    # The worker's span is not the main span's child: only ``child`` is.
    assert t["main"].total_ms - t["main"].self_ms == pytest.approx(t["child"].total_ms)
    assert t["main"].self_ms >= 20.0


def test_spans_off_cost_well_under_a_microsecond():
    assert obs.span("x") is obs.span("y")
    n = 20_000
    best = min(_timed(n) for _ in range(5))
    assert best / n < 1e-6, best / n
    assert obs.totals() == {}


def _timed(n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with obs.span("progressive.step"):
            pass
    return time.perf_counter() - t


def test_host_read_is_bool_and_counts():
    assert obs.host_read("site", torch.tensor([False, True]).any()) is True
    assert obs.host_read("site", torch.tensor(False)) is False
    obs.count("x", 3)
    assert obs.counters() == {"host_read.site": 2, "x": 3}
    assert obs.totals() == {}
    obs.enabled(True)
    obs.host_read("site", torch.tensor(True))
    assert obs.totals()["host_read.site"].calls == 1
    obs.reset()
    assert obs.counters() == {} and obs.totals() == {}


def _spy(monkeypatch, owner, attr, calls: list):
    fn = getattr(owner, attr)

    def spy(*args, **kw):
        calls.append(attr)
        return fn(*args, **kw)

    monkeypatch.setattr(owner, attr, spy)


def test_counters_equal_the_bounces_and_reads_made(bunny, monkeypatch):
    scene, cfg = bunny
    loops, bounces, walks, rounds = [], [], [], []
    _spy(monkeypatch, integrator, "_loop", loops)
    _spy(monkeypatch, integrator, "_bounce", bounces)
    _spy(monkeypatch, packet, "_phase_a_chunk", walks)
    _spy(monkeypatch, packet, "_dispatch_hits", rounds)
    st = progressive.init_state(cfg, "cpu")
    frames = 2
    for _ in range(frames):
        progressive.step(scene, cfg, st)
    c = obs.counters()
    assert len(loops) == frames and 0 < len(bounces) < frames * cfg.max_depth
    assert c["integrator.bounces"] == len(bounces)
    # Each loop reads its done mask before every bounce and once more to stop.
    assert c["host_read.integrator.done"] == len(bounces) + len(loops)
    # Phase A reads its condition before each batch of CHECK_EVERY and once
    # more to stop; one chunk of tiles reads the round condition once a round.
    assert c["packet.phase_a_iterations"] % packet.CHECK_EVERY == 0
    assert c["host_read.packet.walk"] == len(walks) + \
        c["packet.phase_a_iterations"] // packet.CHECK_EVERY
    assert c["host_read.packet.rounds"] == len(rounds)
    assert set(c) == {"integrator.bounces", "host_read.integrator.done", "host_read.packet.walk",
                      "host_read.packet.rounds", "packet.phase_a_iterations"}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_phase_a_kernel_iterations_count_on_the_card_only(device, bunny):
    """``packet.phase_a_kernel_iterations`` counts the walk iterations that
    ran in the walk kernel: on the card, which launches it for every batch,
    every one of ``packet.phase_a_iterations``; on the CPU, which walks
    with ``_body``, it is absent."""
    scene, cfg = bunny
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
        desc = _small(get_scene("W9 E1 Bunny"))
        scene, cfg = build_scene(desc, device)
        scene = with_seeded_env(scene, desc, device)
    st = progressive.init_state(cfg, device)
    for _ in range(2):
        progressive.step(scene, cfg, st)
    c = obs.counters()
    assert c["packet.phase_a_iterations"] > 0
    if device == "cpu":
        assert "packet.phase_a_kernel_iterations" not in c
    else:
        assert c["packet.phase_a_kernel_iterations"] == c["packet.phase_a_iterations"]


def _frames(scene, cfg, n: int = 2):
    st = progressive.init_state(cfg, "cpu")
    for _ in range(n):
        progressive.step(scene, cfg, st)
    return st.accum.clone()


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", ["path", "direct", "shadowed"])
def test_frames_bitwise_with_spans_on_and_off(kind, bunny, dragon):
    scene, cfg = bunny if kind == "path" else dragon
    if kind == "shadowed":
        cfg = dataclasses.replace(cfg, lights=("directional",), shadows=True, ambient="mix")
    off = _frames(scene, cfg)
    reads = obs.counters()
    obs.reset()
    obs.enabled(True)
    on = _frames(scene, cfg)
    assert torch.equal(_bits(off), _bits(on))
    assert obs.counters() == reads
    spans = set(obs.totals())
    assert {"progressive.step", "integrator.bounce", "integrator.trace_closest",
            "integrator.shade"} <= spans
    if kind == "path":
        assert {"packet.phase_a", "packet.phase_b", "host_read.packet.walk"} <= spans
    else:
        assert {"flat.emissions", "super_hits.sweep", "host_read.flat.repair"} <= spans
    if kind == "shadowed":
        assert {"integrator.trace_occluded", "super_occluded.occluded"} <= spans


def test_gradient_step_bitwise_with_spans_on_and_off(dragon):
    scene, cfg = dragon
    cfg = dataclasses.replace(cfg, loop="scan", max_depth=2)
    target = torch.full((SIZE * SIZE, 3), 0.25)
    off = G._leaf_grads(scene, lambda s: G.l2_loss(s, cfg, target))
    obs.enabled(True)
    on = G._leaf_grads(scene, lambda s: G.l2_loss(s, cfg, target))
    for k in off:
        assert torch.equal(_bits(off[k]), _bits(on[k])), k
    t = obs.totals()
    assert t["grad.forward"].calls == t["grad.backward"].calls == 1
    assert t["grad.forward"].total_ms > t["integrator.trace_closest"].total_ms > 0


def _profiled_names(scene, cfg) -> set:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(scene, cfg, 1)
    return {e.name for e in prof.events() if e.name.startswith(obs.PREFIX)}


def test_profiler_sees_spans_only_when_on(bunny):
    scene, cfg = bunny
    assert _profiled_names(scene, cfg) == set()
    obs.enabled(True)
    names = _profiled_names(scene, cfg)
    assert {obs.PREFIX + n for n in ("progressive.step", "integrator.bounce",
                                     "integrator.trace_closest", "integrator.shade",
                                     "packet.phase_a", "packet.phase_b",
                                     "host_read.packet.walk", "host_read.integrator.done",
                                     "host_read.packet.rounds")} <= names
    # Under the profiler the spans go to the trace, not to the host-clock sums.
    assert obs.totals() == {}


def test_cli_profile_traces_the_layers(tmp_path):
    assert cli.main(["--device", "cpu", "--scene", "W9 E1 Bunny", "--width", "8", "--height",
                     "8", "--stats-every", "0", "--profile", str(tmp_path / "prof")]) == 0
    assert obs.SPANS is False
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {obs.PREFIX + "progressive.step", obs.PREFIX + "packet.phase_a"} <= names


def test_cornell_frame_opens_the_engine_and_shading_spans(cornell):
    scene, cfg = cornell
    obs.enabled(True)
    _frames(scene, cfg, 1)
    t = obs.totals()
    assert CORNELL_SPANS <= set(t)
    bounces = obs.counters()["integrator.bounces"]
    # One closest-hit query, one shadow ray and one area-light sample a bounce.
    assert t["brute.closest"].calls == t["brute.occluded"].calls == bounces
    assert t["integrator.nee"].calls == bounces
    # The shadow ray's query lies inside the estimate, and is not its self time.
    assert t["integrator.nee"].total_ms > t["integrator.nee"].self_ms
    assert t["integrator.trace_occluded"].total_ms >= t["brute.occluded"].total_ms


def test_brute_pairs_are_rays_times_triangles(cornell, monkeypatch):
    scene, cfg = cornell
    pairs = []
    for name in ("mesh_brute_force", "mesh_brute_force_anyhit"):
        fn = getattr(intersect, name)

        def spy(rays, vertices, indices, fn=fn):
            pairs.append(rays.o.shape[0] * indices.shape[0])
            return fn(rays, vertices, indices)

        monkeypatch.setattr(intersect, name, spy)
    _frames(scene, cfg, 2)
    assert scene.geom.indices.shape[0] == 12
    assert pairs and all(p == SIZE * SIZE * 12 for p in pairs)
    assert obs.counters()["brute.pairs"] == sum(pairs)
    assert len(pairs) == 2 * obs.counters()["integrator.bounces"]


def test_cornell_frames_bitwise_with_spans_on_and_off(cornell):
    scene, cfg = cornell
    off = _frames(scene, cfg)
    counts = obs.counters()
    obs.reset()
    obs.enabled(True)
    on = _frames(scene, cfg)
    assert torch.equal(_bits(off), _bits(on))
    assert obs.counters() == counts
    assert CORNELL_SPANS <= set(obs.totals())


@pytest.mark.parametrize("kind", ["path", "direct"])
def test_bunny_and_dragon_open_none_of_the_cornell_spans(kind, bunny, dragon):
    scene, cfg = bunny if kind == "path" else dragon
    obs.enabled(True)
    _frames(scene, cfg, 1)
    assert {"progressive.step", "integrator.shade"} <= set(obs.totals())
    assert not CORNELL_SPANS & set(obs.totals())
    assert "brute.pairs" not in obs.counters()

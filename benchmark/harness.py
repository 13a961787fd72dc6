"""One run of one cell: set-up, the measured window, the per-layer
readings, and the comparison that decides ``correct``.

Everything particular to a configuration, a traffic mix or a per-layer
metric is data or a module found by name:

* ``BENCHMARK.json`` lists the cells and metrics;
* ``benchmark/configs/<config>.json``: the registry row, its resolution,
  camera, shading (``scene``, every key checked against the row), material,
  mesh (a procedural stand-in, ``model`` + ``standin``, or a model file of
  the repository, ``obj``), analytic primitives (``spheres``, ``planes``,
  ``tris``, checked against the row), ``source``, ``reduced`` and
  ``assumed``;
* ``benchmark/workloads/<cell>.json``: the traffic: ``loop`` names the
  module of ``benchmark/loops/`` that drives the program in the window,
  ``reference`` the module of ``benchmark/reference/`` that recomputes
  and judges its output; then the shading overrides both sides apply,
  how the output is checked and the limits of the check, the ``why``;
* ``benchmark/metrics/<metric>.py``: a per-layer reader, ``read(probe)``
  and optionally ``install(probe)`` (see ``Probe``).

A loop module holds ``UNIT`` ("frame", "step") and ``prepare(cell,
inputs, scene, cfg, device, sync)``, which warms up and returns (one unit
of work ending in ``sync``, ``output(seed, units)``: the program's answer
and the numbers it carries itself, such as ``frames_missing``). A
reference module holds ``output(cell, inputs, seed, mesh, units, device,
r)``, the reference's (answer, aux) in the precision ``r``, and
``numbers(prog, answer, aux)``. Its ``mesh`` is the benchmark's own
(``reference_mesh``): the stand-in's (V, Nv, I), or for an ``obj``
configuration an ``objfile.Mesh``, whose first three fields are those and
which adds each face's material and the stated primitives.

The program is the PyTorch port, ``tracer_torch``; nothing here imports
``tracer`` or ``jax``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import inputs as inp, trace as tr
from benchmark.reference import compare, env as ref_env
from benchmark.reference import render as R
from benchmark.reference import objfile, standin

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tracer")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that must not be loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list  # manifest entries this cell reports
    per_layer: list

    @property
    def loop(self):
        return importlib.import_module(f"benchmark.loops.{self.traffic['loop']}")

    @property
    def reference(self):
        return importlib.import_module(f"benchmark.reference.{self.traffic['reference']}")

    @property
    def unit(self) -> str:
        return self.loop.UNIT


def cell(root: Path, name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files loaded;
    ``overrides`` ({"config": {...}, "traffic": {...}}) replaces top-level
    keys of either file."""
    manifest = load_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    mine = lambda m: name in m.get("workloads", [name])
    return Cell(name, config, traffic, [m for m in manifest["end_to_end"] if mine(m)],
                [m for m in manifest["per_layer"] if mine(m)])


# --- the program's side -----------------------------------------------------


PRIMITIVES = ("spheres", "planes", "tris")


def _plain(x):
    """``x`` with every tuple a list, all the way down, as JSON states it."""
    return [_plain(v) for v in x] if isinstance(x, (tuple, list)) else x


def build(c: Cell, inputs: dict, device, timings: dict):
    """(scene, cfg) built by the program from the configuration's row, at
    the configuration's resolution, with the traffic's shading overrides,
    the seeded environment (``env``). The mesh is the stand-in that the
    row's model, renamed to ``model``, stands for (``standin``: the
    generator's arguments, with its normals turned outward where
    ``flip_normals`` asks), or the repository's file that ``obj`` names
    (``file``, relative to the repository's root, and ``scale``). Raises
    if the row's shading differs from any key that the configuration's
    ``scene`` (with the traffic's overrides) states, if its camera, its
    analytic primitives or its model's scale differ from the
    configuration's, or if the row has primitives that the configuration
    does not state."""
    from tracer_torch.geometry.device import refresh_tri_table
    from tracer_torch.render import texture
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    conf = c.config
    desc = get_scene(conf["row"])
    cfg = dataclasses.replace(desc.cfg, width=conf["width"], height=conf["height"],
                              **{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in c.traffic.get("cfg", {}).items()})
    for k, want in inp.scene_config(conf, c.traffic).items():
        if not hasattr(cfg, k):
            raise ValueError(f"{conf['row']}: the row has no setting {k!r}")
        if _plain(getattr(cfg, k)) != want:
            raise ValueError(f"{conf['row']}: {k} is {getattr(cfg, k)!r}, the configuration "
                             f"states {want!r}")
    cam0 = {k: _plain(v) for k, v in desc.camera.items()}
    if any(cam0[k] != conf["camera"][k] for k in ("eye", "target", "up", "constant")):
        raise ValueError(f"{conf['row']}: camera {cam0} differs from the configuration's")
    for k in PRIMITIVES:
        got, want = _plain(getattr(desc, k)), conf.get(k, [])
        if got != want:
            raise ValueError(f"{conf['row']}: {k} {got} differ from the configuration's {want}")
    if "obj" in conf:
        if desc.model_scale != conf["obj"]["scale"]:
            raise ValueError(f"{conf['row']}: model scale {desc.model_scale!r}, the "
                             f"configuration states {conf['obj']['scale']!r}")
        model = str(ROOT / conf["obj"]["file"])
    else:
        model = str(Path(desc.model).with_name(conf["model"]))
    desc = dataclasses.replace(desc, cfg=cfg, model=model, camera=dict(inputs["camera"]))
    scene, cfg = build_scene(desc, device, timings=timings)
    if "obj" not in conf and conf["standin"].get("flip_normals"):
        geom = dataclasses.replace(scene.geom, normals=-scene.geom.normals)
        scene = dataclasses.replace(scene, geom=refresh_tri_table(geom))
    if conf.get("env"):
        env = ref_env.seeded_env(False, inputs["env_seed"], tuple(conf["env"]["shape"]))
        scene = dataclasses.replace(scene, env=texture.TextureBuf(
            data=torch.as_tensor(env, device=device), kind=texture.ENV_LDR))
    return scene, cfg


# --- per-layer readers ------------------------------------------------------


class Probe:
    """What a per-layer reader sees. A traced run has two windows: first
    ``phase == "host"``, as long as an untraced run's, without the
    profiler (``host_units`` frames or steps), then ``phase == "trace"``,
    ``trace_units`` frames or steps under the profiler. ``install`` may
    ``wrap`` a function of the program for both (restored after them);
    ``read`` takes ``trace`` (a ``trace.Trace`` of the second),
    ``unit_spans`` ((start, end) us of each traced frame or step),
    ``build_timings``, ``peak_bytes`` (allocated device memory's peak over
    both), ``host_ms`` (host-clock sums that ``host_timed`` wrappers add
    under a name, in the first window only) and ``captured`` (whatever a
    wrapper keeps), and returns a number or None where it finds nothing."""

    def __init__(self, unit: str):
        self.unit = unit
        self.phase = "host"
        self.unit_index = -1
        self.host_units = 0
        self.trace_units = 0
        self.trace = tr.Trace()
        self.build_timings: dict = {}
        self.peak_bytes = 0
        self.host_ms: dict = {}
        self.captured: dict = {}
        self._restore = []

    def wrap(self, owner, attr: str, make):
        """Replace ``owner.attr`` by ``make(original)`` until ``unwrap``."""
        orig = getattr(owner, attr)
        self._restore.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def host_timed(self, name: str):
        """A ``make`` for ``wrap`` that adds each call's host-clock ms under
        ``name`` in ``host_ms``, in the untraced window only (the profiler
        slows every host operation)."""
        def make(fn):
            def run(*args, **kw):
                if self.phase != "host":
                    return fn(*args, **kw)
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.host_ms[name] = self.host_ms.get(name, 0.0) + (
                        time.perf_counter() - t) * 1e3
            return run
        return make

    def unwrap(self):
        while self._restore:
            owner, attr, orig = self._restore.pop()
            setattr(owner, attr, orig)

    @property
    def unit_spans(self) -> list:
        return [(a, b) for n, a, b in sorted(self.trace.spans, key=lambda s: s[1])
                if n == self.unit]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the window -------------------------------------------------------------


def window(unit_fn, seconds: float, max_units: int, probe: "Probe | None") -> list:
    """Call ``unit_fn`` (one frame or step, ending in a synchronize) until
    ``seconds`` have passed or ``max_units`` calls are done (0: no cap);
    returns each call's host seconds. With a ``probe`` (a traced window)
    each call is a host span named after the unit."""
    times = []
    t0 = prev = time.perf_counter()
    while True:
        if probe is not None:
            probe.unit_index = len(times)
            with tr.span(probe.unit):
                unit_fn()
        else:
            unit_fn()
        now = time.perf_counter()
        times.append(now - prev)
        prev = now
        if now - t0 >= seconds or (max_units and len(times) >= max_units):
            return times


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def end_to_end(c: Cell, times: list, setup_s: float) -> dict:
    n = len(times)
    total = sum(times)
    p95 = sorted(times)[max(0, math.ceil(0.95 * n) - 1)]
    have = {f"{c.unit}_ms": total / n * 1e3, f"{c.unit}_p95_ms": p95 * 1e3, "setup_s": setup_s}
    return {m["name"]: {"value": have[m["name"]], "unit": m["unit"]}
            for m in c.end_to_end if m["name"] in have}


def run(name: str, seed: int, seconds: float, trace: bool, device, *, root: Path,
        t_start: float, overrides: dict | None = None, keep: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result (the last line's keys,
    ``checks`` last, and ``stages``). ``keep``, where given, receives what
    the check used (``cell``, ``inputs``, ``mesh``, ``units``, ``numbers``),
    so that a caller can compare the control on the same inputs."""
    c = cell(root, name, overrides)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    stages = {"start_s": time.perf_counter() - t_start}
    inputs = inp.seeded(c.config, seed)
    timings: dict = {}
    scene, cfg = build(c, inputs, dev, timings)
    sync(dev)
    stages["build_s"] = time.perf_counter() - t_start - stages["start_s"]
    unit_fn, output = c.loop.prepare(c, inputs, scene, cfg, dev, sync)
    probe = Probe(c.unit)
    probe.trace_units = int(c.traffic["trace_units"])
    readers = {m["name"]: load_reader(m["name"]) for m in c.per_layer} if trace else {}
    for rd in readers.values():
        if hasattr(rd, "install"):
            rd.install(probe)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    stages["warm_s"] = setup_s - stages["build_s"] - stages["start_s"]
    times = window(unit_fn, seconds, 0, None)
    if trace:
        probe.host_units = len(times)
        probe.phase = "trace"
        with tr.traced(probe.trace):
            traced = window(unit_fn, seconds, probe.trace_units, probe)
        probe.unwrap()
        probe.trace.units = len(traced)
        times += traced
    sync(dev)
    t_window = time.perf_counter()
    stages["window_s"] = t_window - t_start - setup_s
    stages.update(units=len(times), unit_min_ms=min(times) * 1e3,
                  unit_median_ms=sorted(times)[len(times) // 2] * 1e3, unit_max_ms=max(times) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    probe.peak_bytes, probe.build_timings = peak, timings
    result = {"correct": False, "attempted": len(times), "failed": 0}
    if trace:
        metrics = {}
        for m in c.per_layer:
            v = readers[m["name"]].read(probe)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = end_to_end(c, times, setup_s)
    result["metrics"] = metrics
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = probe.trace.busy_us() / 1e6
        device_info["window_s"] = probe.trace.window_us / 1e6
    result["device"] = device_info
    if trace and probe.trace.device:
        result["breakdown"] = probe.trace.breakdown()
    del probe, readers
    # The program's outputs, then its state freed before the reference runs.
    mesh = reference_mesh(c.config)
    differs = mesh_differs(scene, mesh)
    prog, own = output(seed, len(times))
    del scene, unit_fn, output
    if on_card:
        torch.cuda.empty_cache()
    limits = dict(c.traffic["limits"], mesh_differs=0.0)
    if any(own.values()):
        # The program's own numbers already fail (a frame counter that
        # disagrees with the frames completed): nothing to compare.
        numbers = {k: math.inf for k in limits}
    else:
        numbers = reference_numbers(c, inputs, seed, prog, mesh, len(times), dev)
    numbers.update(own, mesh_differs=differs)
    if keep is not None:
        keep.update(cell=c, seed=seed, inputs=inputs, mesh=mesh, units=len(times), prog=prog,
                    numbers=numbers, limits=limits)
    ok, checks = compare.judge({k: numbers[k] for k in limits}, limits)
    result["correct"] = ok
    result["failed"] = 0 if ok else len(times)
    result["checks"] = checks
    stages["check_s"] = time.perf_counter() - t_window
    result["stages"] = stages
    return result


def reference_mesh(conf: dict):
    """The benchmark's own mesh of a configuration: the frozen stand-in's
    (V, Nv, I), or the frozen parse of its ``obj`` file with each face's
    material and the stated primitives (``objfile.Mesh``)."""
    if "obj" not in conf:
        return standin.make(conf["standin"])
    o = conf["obj"]
    mesh = objfile.load(ROOT / o["file"], o["scale"])
    return mesh._replace(**{k: conf.get(k, []) for k in PRIMITIVES})


def mesh_differs(scene, mesh) -> float:
    """0.0 where the program's mesh is the benchmark's bit for bit: the
    vertices, normals and indices, and for an ``objfile.Mesh`` also each
    face's diffuse and emitted colour (the program's material table at its
    material ids) and the light list; else 1.0."""
    V, Nv, I = mesh[:3]
    g = scene.geom
    bits = lambda x: x.detach().cpu().contiguous().view(torch.int32)
    same = (tuple(g.vertices.shape) == V.shape and tuple(g.indices.shape) == I.shape
            and torch.equal(bits(g.vertices), torch.from_numpy(V).view(torch.int32))
            and torch.equal(bits(g.normals), torch.from_numpy(Nv).view(torch.int32))
            and torch.equal(g.indices.cpu().to(torch.int64),
                            torch.from_numpy(I.astype(np.int64))))
    if same and isinstance(mesh, objfile.Mesh):
        mats, ids = scene.materials, g.mat_ids.long()
        lights = np.flatnonzero(mesh.light)
        same = (torch.equal(bits(mats.diffuse[ids]), torch.from_numpy(mesh.kd).view(torch.int32))
                and torch.equal(bits(mats.emission[ids]),
                                torch.from_numpy(mesh.emission).view(torch.int32))
                and torch.equal(scene.light_indices.cpu().to(torch.int64),
                                torch.from_numpy(lights.astype(np.int64))))
    return 0.0 if same else 1.0


def reference_numbers(c: Cell, inputs: dict, seed: int, prog, mesh_np, units: int, device,
                      prec: str = "exact", leaves: dict | None = None) -> dict:
    """The comparison's numbers for the program's answer ``prog`` against
    the cell's reference; ``prec`` the reference's precision: ``tf32``
    for the control, whose answer is then compared in the program's
    place. ``leaves``, for a gradient cell, receives each leaf's norm and
    error."""
    ref = c.reference
    answer, aux = ref.output(c, inputs, seed, mesh_np, units, device, R.exact)
    if prec != "exact":
        prog = ref.output(c, inputs, seed, mesh_np, units, device, R.PRECISIONS[prec])[0]
    elif not isinstance(prog, dict):
        prog = prog.to(answer.device)
    if leaves is not None:
        return ref.numbers(prog, answer, aux, leaves=leaves)
    return ref.numbers(prog, answer, aux)


def control(keep: dict, device, prec: str = "tf32", leaves: dict | None = None):
    """(correct, checks, every number) of the control on a run's inputs
    (``keep`` from ``run``): the reference in precision ``prec`` put in the
    program's place and judged by the run's limits; the numbers the
    program carries itself (``frames_missing``, ``mesh_differs``) stay the
    run's."""
    numbers = dict(keep["numbers"])
    numbers.update(reference_numbers(keep["cell"], keep["inputs"], keep["seed"], None,
                                     keep["mesh"], keep["units"], device, prec=prec,
                                     leaves=leaves))
    limits = keep["limits"]
    return (*compare.judge({k: numbers[k] for k in limits}, limits), numbers)

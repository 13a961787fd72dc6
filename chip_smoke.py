"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure, so the script exits non-zero):

1. probe    — a CUDA device must be visible; prints its name and power limit;
2. build    — compiles the two kernels (``tracer_torch/csrc``: super-tile
              hits B1 and vertex-cotangent placement B2) with nvcc for
              sm_90a, in parallel, and prints their register and shared
              memory use;
3. kernel   — each kernel against its plain-PyTorch twin on the card. B1 in
              both modes, on synthetic emissions (zero gate words, en < K,
              dead -3e38 windows) and on the emissions of a real dragon
              frame: ids equal and t equal bit for bit. B2 on synthetic
              streams (``scatter_streams``) and on the real stream of a
              dragon gradient step: two launches equal bitwise, equal
              bitwise to the twin run on a CPU copy (the same sequential
              order), and within the float32 bound of a length-L sum of
              the twin on the card (atomics, no fixed order);
4. frame    — ``Project: Dragon`` at 800x450 (the 869,880-triangle stand-in,
              native LBVH) through 1 warm-up and 20 timed
              ``progressive.step`` frames, then checks: every frame ran B1
              and never its twin, every lane converged, the accumulator is
              finite, miss pixels equal the background bitwise, and the
              frame's hit ids equal those of the same frame traced by the
              twin; a 64x48 ``Project: Bunny`` frame must also agree with
              the JAX package's render of it (summary numbers below);
5. gradient — ``grad_scene`` on the same dragon (target zeros, as the JAX
              package's ``bench.py`` runs it) through 1 warm-up and 5 timed
              steps, then checks: every step ran both kernels and neither
              twin, every gradient leaf is finite, the vertex, normal,
              diffuse and eye gradients are nonzero, two steps agree bit for
              bit on every leaf, and ``fd_check`` passes on the diffuse
              albedo; a 64x48 ``Project: Bunny`` gradient must agree with
              the JAX package's (``BUNNY_GRAD_REF``) and pass ``fd_check``
              on a rigid z-translation of its vertices.

Prints one JSON object of per-kernel results on the line before the last,
and ``{"ok": true, "device": {...}}`` as the last line. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# The JAX package's render of Project: Bunny at 64x48, frame 0, on the CPU
# (tracer.render.integrator.render_sample): hit and miss pixel counts and
# the sum and sum of squares of the hit pixels' radiance. The stand-in's
# winding gives most lit pixels a negative Lambert cosine, which the
# reference keeps unclamped (project.wgsl), hence the negative sum.
BUNNY_REF = dict(hits=2908, misses=164, sum=-9860.647191603435,
                 sumsq=15683.204618622814)

# The JAX package's gradient of the L2 loss against target zeros for the same
# bunny (tracer.diff.grad.grad_scene with loop="scan", max_depth=2, one
# sample, on the CPU): per leaf (sum, sum of |x|, sum of x^2) in float64.
# ``tests/test_torch_grad.py`` recomputes them from JAX, so they cannot go
# stale. Loss 1.7099223136901855; materials.specular and geom.tri_table
# are exactly 0.
BUNNY_GRAD_REF = {
    "geom.vertices": (-27.180378784841217, 101.0493472973699, 4.5573628653251586),
    "geom.normals": (-5.2365071077734235, 6.35709963575604, 0.004595286197996851),
    "materials.diffuse": (6.806951522827148, 6.806951522827148, 15.444863011372945),
    "materials.emission": (-0.21398960798978806, 0.21398960798978806, 0.015263850775874388),
    "camera.eye": (4.940001666545868, 4.940001666545868, 8.79764545371248),
    "camera.target": (22.24037742614746, 22.24037742614746, 250.0757338176354),
    "camera.constant": (-0.1517091989517212, 0.1517091989517212, 0.023015681046572922),
}
BUNNY_GRAD_ZERO = ("materials.specular", "geom.tri_table")
# The port's CPU gradient of the bunny (its own build_scene) agrees with
# these at 5.5e-6 relative at worst (geom.vertices' sum of squares): the
# same formulas, but XLA contracts multiply-adds into FMAs and sums the
# lanes in another order. 1e-4 leaves a margin of 18x for the card, whose
# reductions over lanes (the camera's broadcast, the material product) take
# yet another order. Each statistic is compared relative to its own
# sum-of-|x| scale (the sum of squares to itself).
BUNNY_GRAD_RTOL = 1e-4


def grad_stats(arrays: dict) -> dict:
    """(sum, sum |x|, sum x^2) in float64 per leaf of ``grads_to_arrays``."""
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a, np.float64)
        out[k] = (float(a.sum()), float(np.abs(a).sum()), float((a * a).sum()))
    return out


def bunny_grad_errors(stats: dict, rtol: float = BUNNY_GRAD_RTOL) -> list:
    """The statistics of ``stats`` that miss ``BUNNY_GRAD_REF`` by more than
    ``rtol`` of their scale, and nonzero leaves that must be zero."""
    bad = []
    for k, (s, a, q) in BUNNY_GRAD_REF.items():
        gs, ga, gq = stats[k]
        if abs(gs - s) > rtol * a or abs(ga - a) > rtol * a or abs(gq - q) > rtol * q:
            bad.append(f"{k}: ({gs!r}, {ga!r}, {gq!r}) vs ({s!r}, {a!r}, {q!r})")
    bad += [f"{k} is not zero" for k in BUNNY_GRAD_ZERO if stats[k][1] != 0.0]
    return bad


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_events_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want):
    """Kernel vs twin: pids equal and t bitwise equal. Returns max |diff|."""
    (kt, kp), (rt, rp) = got, want
    torch.cuda.synchronize()
    if not torch.equal(kp, rp):
        bad = int((kp != rp).sum())
        raise AssertionError(f"{name}: {bad} pids differ from the twin")
    if not torch.equal(kt.view(torch.int32), rt.view(torch.int32)):
        bad = int((kt.view(torch.int32) != rt.view(torch.int32)).sum())
        raise AssertionError(f"{name}: {bad} t values differ from the twin")
    err = max(float((kt.double() - rt.double()).abs().max()),
              float((kp - rp).abs().max()))
    log(f"  {name}: {kp.numel()} lanes, {int((kp >= 0).sum())} hits/flags, equal bitwise")
    return err


def synthetic(device, any_hit: bool, seed: int):
    """Random triangles in 3 treelets of 1024 (the last partly empty), two
    super-tiles, 12 emission slots with zero gate words, en < K, an id out of
    range, unordered entry distances and dead windows."""
    from tracer_torch.accel import treelet
    from tracer_torch.kernels.super_hits import SUPER

    rs = np.random.RandomState(seed)
    NT, T, n_super, KD = 3, 1024, 2, 12
    ntri = NT * T - 100
    c = rs.uniform(-1.0, 1.0, (ntri, 1, 3)).astype(np.float32)
    c[:, :, 2] *= 0.3
    verts = (c + rs.normal(0.0, 0.08, (ntri, 3, 3))).astype(np.float32).reshape(-1, 3)
    idx = np.arange(ntri * 3, dtype=np.int32).reshape(ntri, 3)
    pids = np.zeros((NT, T), np.int32)
    pids.reshape(-1)[:ntri] = rs.permutation(ntri)
    valid = np.arange(NT * T).reshape(NT, T) < ntri
    t = lambda x: torch.as_tensor(x, device=device)
    qblocks, qbox = treelet.assemble_blocks(t(verts), t(idx), t(pids), t(valid))
    tb = treelet.TreeletBvh(qblocks=qblocks, qbox=qbox, t_lo=t(np.zeros((NT, 3), np.float32)),
                            t_hi=t(np.zeros((NT, 3), np.float32)), T=T)
    n = n_super * SUPER
    o = np.float32([0.0, 0.0, 3.0]) + rs.normal(0.0, 0.05, (n, 3)).astype(np.float32)
    tgt = rs.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    tgt[:, 2] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = rs.uniform(0.0, 2.0, n).astype(np.float32)
    best_t = rs.uniform(2.5, 4.0, n).astype(np.float32)
    best_t[rs.rand(n) < 0.05] = -3.0e38
    best_pid = (np.where(rs.rand(n) < 0.1, 1.0, -1.0) if any_hit
                else np.full(n, -1.0)).astype(np.float32)
    eids = np.stack([rs.permutation(NT * 4) for _ in range(n_super)]).astype(np.int32)
    eids[0, 3] = 99
    enear = np.sort(rs.uniform(0.0, 3.2, (n_super, KD)), axis=1).astype(np.float32)
    enear[1] = rs.uniform(0.0, 3.2, KD)
    gm = rs.randint(0, 1 << 16, (n_super, KD)).astype(np.int32)
    gm[:, 1] = 0
    gm[0, 5] = 0
    en = np.array([KD, 7], np.int32)
    sh = lambda x: t(x.reshape(n_super, SUPER, *x.shape[1:]))
    return (tb, t(eids), t(enear), t(en), t(gm), sh(o), sh(d), sh(tmin),
            sh(best_t), sh(best_pid))


def frame_args(em, tb):
    return (tb, em.ids, em.enear, em.en, em.gm, em.o, em.d, em.tmin, em.bt0, em.bp0)


def scatter_streams(seed: int, long_rows: int = 200_000):
    """Unsorted (name, ids (M,) int32, payload (M, 6) float32, V) vertex-
    cotangent streams from numpy with a seed: duplicates with untouched
    vertices (V = 1000, not a multiple of 512; M = 3001, not a multiple of
    anything), one segment of ``long_rows`` rows among short ones, and
    V = 1."""
    rs = np.random.RandomState(seed)
    out = []
    V, M = 1000, 3001
    ids = rs.randint(0, 700, M)  # vertices 700..999 and the gaps get no row
    out.append(("duplicates", ids, V))
    V = 777
    ids = np.concatenate([np.full(long_rows, 5), rs.randint(0, V, 4099)])
    out.append((f"segment of {long_rows}", rs.permutation(ids), V))
    out.append(("V = 1", np.zeros(513, np.int64), 1))
    return [(name, ids.astype(np.int32),
             (rs.standard_normal((ids.shape[0], 6)) * rs.choice([1e-3, 1.0, 30.0], (ids.shape[0], 1))
              ).astype(np.float32), V)
            for name, ids, V in out]


def check_segment_place(name, sids, svals, V) -> float:
    """B2 against its twin on the card, for a sorted stream. Two launches
    must agree bitwise; the kernel must equal the twin run on a CPU copy
    (the same sequential sum) bitwise, and lie within L * 2^-23 * sum |x|
    of the twin on the card (atomics, no fixed order), L being each
    vertex's row count. Returns max |kernel - twin on the card|."""
    from tracer_torch.kernels import scatter_vn

    k1 = scatter_vn.segment_place(sids, svals, V)
    k2 = scatter_vn.segment_place(sids, svals, V)
    twin = scatter_vn.segment_place_reference(sids, svals, V)
    torch.cuda.synchronize()
    bits = lambda x: x.cpu().view(torch.int32)
    if not torch.equal(bits(k1), bits(k2)):
        raise AssertionError(f"B2 {name}: two launches differ")
    cpu = scatter_vn.segment_place_reference(sids.cpu(), svals.cpu(), V)
    if not torch.equal(bits(k1), cpu.view(torch.int32)):
        bad = int((bits(k1) != cpu.view(torch.int32)).sum())
        raise AssertionError(f"B2 {name}: {bad} sums differ from the CPU twin")
    rows = torch.bincount(sids.long(), minlength=V).double()[:, None]
    mag = scatter_vn.segment_place_reference(sids, svals.abs(), V).double()
    diff = (k1.double() - twin.double()).abs()
    if bool((diff > rows * 2.0 ** -23 * mag).any()):
        raise AssertionError(f"B2 {name}: kernel and twin on the card differ by more "
                             "than the float32 bound of a length-L sum")
    err = float(diff.max()) if diff.numel() else 0.0
    log(f"  B2 {name}: M={sids.shape[0]} V={V}, longest segment {int(rows.max())}; "
        f"launches equal bitwise, = CPU twin bitwise, max |kernel - card twin| {err:.3g}")
    return err


def main() -> int:
    # 1. Probe.
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()} limit"
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")

    import tracer_torch
    from tracer_torch import convert
    from tracer_torch.accel import flat
    from tracer_torch.diff import grad as G
    from tracer_torch.geometry.device import refresh_tri_table
    from tracer_torch.kernels import scatter_vn, super_hits
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    dev = tracer_torch.cuda_device()
    kernels = (super_hits, scatter_vn)

    def reset_counts():
        for mod in kernels:
            mod.KERNEL_LAUNCHES = mod.REFERENCE_CALLS = 0

    # 2. Build: one nvcc per source, all started together.
    def timed_build(mod):
        t = time.perf_counter()
        return mod.build()[1], time.perf_counter() - t

    with ThreadPoolExecutor(len(kernels)) as pool:
        builds = list(pool.map(timed_build, kernels))
    for mod, (build_log, secs) in zip(kernels, builds):
        log(f"[build] {mod.SOURCE.name} -> sm_90a in {secs:.2f} s")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")

    # 3a. Kernel against the twin, synthetic emissions.
    log("[kernel vs twin] synthetic emissions")
    max_err = 0.0
    for any_hit in (False, True):
        for seed in (0, 1):
            args = synthetic(dev, any_hit, seed)
            got = super_hits.hits2(*args, any_hit)
            want = super_hits.hits2_reference(*args, any_hit)
            max_err = max(max_err, compare(
                f"synthetic {'any-hit' if any_hit else 'closest'} seed {seed}", got, want))
    log("[kernel vs twin] B2 synthetic streams")
    b2_err = 0.0
    for name, ids, vals, V in scatter_streams(0):
        ids_t = torch.as_tensor(ids, device=dev)
        sids, perm = torch.sort(ids_t, stable=True)
        b2_err = max(b2_err, check_segment_place(
            name, sids, torch.as_tensor(vals, device=dev)[perm].contiguous(), V))

    # 4a. Main path: build the dragon at full size.
    desc = get_scene("Project: Dragon")
    timings: dict = {}
    t0 = time.perf_counter()
    scene, cfg = build_scene(desc, dev, timings=timings)
    log(f"[main] {desc.name} {cfg.width}x{cfg.height}: "
        f"{scene.geom.indices.shape[0]} triangles, {scene.tb.NT} treelets, "
        f"built in {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k}={v:.3f}s" for k, v in timings.items()) + ")")
    if (cfg.width, cfg.height) != (800, 450) or scene.geom.indices.shape[0] != 869_880:
        raise AssertionError("the dragon frame is not at full size")
    rays = integrator.primary_rays(scene, cfg)
    frame = (cfg.width, cfg.height)

    # 3b. Kernel against the twin on the real frame's emissions.
    log("[kernel vs twin] dragon frame emissions")
    em_closest = flat.emissions(rays, scene.tb, frame)
    em_any = flat.emissions(rays, scene.tb, frame, any_hit=True)
    log(f"  {em_closest.n_super} super-tiles x {em_closest.ids.shape[1]} emission slots, "
        f"mean {float(em_closest.en.float().mean()):.1f} emissions/super-tile, "
        f"{int(em_closest.overflow.sum())} overflowing")
    for name, em, any_hit in (("frame closest", em_closest, False),
                              ("frame any-hit", em_any, True)):
        args = frame_args(em, scene.tb)
        max_err = max(max_err, compare(name, super_hits.hits2(*args, any_hit),
                                       super_hits.hits2_reference(*args, any_hit)))

    # 4b. Main path: 1 warm-up + 20 timed progressive frames.
    state = progressive.init_state(cfg, dev)
    reset_counts()
    progressive.step(scene, cfg, state)
    torch.cuda.synchronize()
    frames = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        progressive.step(scene, cfg, state)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, ref_calls = super_hits.KERNEL_LAUNCHES, super_hits.REFERENCE_CALLS
    if scatter_vn.KERNEL_LAUNCHES or scatter_vn.REFERENCE_CALLS:
        raise AssertionError("the forward frame placed vertex cotangents")
    ms_frame = start.elapsed_time(end) / frames
    mrays = cfg.width * cfg.height / (ms_frame * 1e-3) / 1e6
    log(f"[main] {frames} frames: {ms_frame:.3f} ms/frame (CUDA events), "
        f"{wall / frames * 1e3:.3f} ms/frame (host clock), {mrays:.1f} Mray/s; {card}")
    log(f"[main] kernel launches {launches} over {frames + 1} frames, twin calls {ref_calls}")
    if launches < frames + 1 or ref_calls != 0:
        raise AssertionError("the main path did not run on the kernel alone")
    if state.iteration != frames + 1:
        raise AssertionError(f"iteration {state.iteration} after {frames + 1} steps")

    # 4c. Checks on what came out.
    acc = state.accum
    if acc.shape != (cfg.width * cfg.height, 3) or not bool(torch.isfinite(acc).all()):
        raise AssertionError("accumulator has the wrong shape or non-finite values")
    seed = state.seed_t
    t_k, ids_k, conv = flat.closest_hit(rays, scene.tb, frame, with_conv=True, seed_t=seed)
    t_r, ids_r = flat.closest_hit(rays, scene.tb, frame, seed_t=seed,
                                  hits=super_hits.hits2_reference)
    if not bool(conv.all()):
        raise AssertionError(f"{int((~conv).sum())} lanes did not converge")
    if not torch.equal(ids_k, ids_r) or not torch.equal(t_k, t_r):
        raise AssertionError(
            f"frame hit ids differ from the twin's on {int((ids_k != ids_r).sum())} lanes")
    radiance, _ = integrator.render_sample_seeded(scene, cfg, seed)
    bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev)
    miss = ids_k < 0
    if not torch.equal(radiance[miss], bg.expand(int(miss.sum()), 3)):
        raise AssertionError("miss pixels differ from the background colour")
    # The running mean of a constant drifts from it by rounding only.
    if not torch.allclose(acc[miss], bg.expand(int(miss.sum()), 3), rtol=1e-6, atol=0):
        raise AssertionError("accumulated miss pixels drifted from the background")
    err_color = torch.tensor(integrator.ERROR_COLOR, device=dev)
    if bool((radiance == err_color).all(dim=-1).any()):
        raise AssertionError("a lane rendered the truncation sentinel")
    log(f"[main] frame: {int((~miss).sum())} hit / {int(miss.sum())} miss pixels; "
        f"all lanes converged; ids and t equal the twin's; miss pixels = bg_color")

    # Small input against the JAX package's numbers.
    bdesc = get_scene("Project: Bunny")
    bdesc = dataclasses.replace(bdesc, cfg=dataclasses.replace(bdesc.cfg, width=64, height=48))
    bscene, bcfg = build_scene(bdesc, dev)
    r = integrator.render_sample(bscene, bcfg).double()
    bmiss = (r.float() == torch.tensor(bcfg.bg_color, device=dev)).all(dim=-1)
    hits_b, misses_b = int((~bmiss).sum()), int(bmiss.sum())
    s, s2 = float(r[~bmiss].sum()), float((r[~bmiss] ** 2).sum())
    log(f"[bunny 64x48] hits {hits_b} misses {misses_b} sum {s!r} sumsq {s2!r} "
        f"(JAX: {BUNNY_REF})")
    if abs(hits_b - BUNNY_REF["hits"]) > 0.005 * r.shape[0] \
            or abs(s - BUNNY_REF["sum"]) > 1e-4 * abs(BUNNY_REF["sum"]) \
            or abs(s2 - BUNNY_REF["sumsq"]) > 1e-4 * BUNNY_REF["sumsq"]:
        raise AssertionError("the bunny frame disagrees with the JAX package")

    # 3c. B2 against its twin on the real stream of a dragon gradient step,
    # caught at the kernel's wrapper (outside the counted runs).
    gcfg = dataclasses.replace(cfg, loop="scan", max_depth=2)
    target = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32, device=dev)
    caught = []
    place = scatter_vn.segment_place

    def catch(*args):
        caught.append(args)
        return place(*args)

    scatter_vn.segment_place = catch
    G.grad_scene(scene, gcfg, target)
    scatter_vn.segment_place = place
    (sids_d, svals_d, v_d), = caught
    log("[kernel vs twin] B2 dragon gradient stream")
    b2_err = max(b2_err, check_segment_place("dragon gradient step", sids_d, svals_d, v_d))

    # 5a. Main path, gradient step: 1 warm-up + 5 timed steps.
    reset_counts()
    g = G.grad_scene(scene, gcfg, target)
    torch.cuda.synchronize()
    steps = 5
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        prev, g = g, G.grad_scene(scene, gcfg, target)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g_launches = {mod.__name__.split(".")[-1]: mod.KERNEL_LAUNCHES for mod in kernels}
    g_ref_calls = sum(mod.REFERENCE_CALLS for mod in kernels)
    ms_step = start.elapsed_time(end) / steps
    fb_mrays = 2 * cfg.width * cfg.height / (ms_step * 1e-3) / 1e6
    log(f"[grad] {steps} steps: {ms_step:.3f} ms/step (CUDA events), "
        f"{wall / steps * 1e3:.3f} ms/step (host clock), fwd+bwd {fb_mrays:.1f} Mray/s; {card}")
    log(f"[grad] kernel launches {g_launches} over {steps + 1} steps, twin calls {g_ref_calls}")
    if min(g_launches.values()) < steps + 1 or g_ref_calls != 0:
        raise AssertionError("the gradient step did not run on the kernels alone")

    # 5b. Checks on the gradients.
    ga, gp = convert.grads_to_arrays(g), convert.grads_to_arrays(prev)
    for k, a in ga.items():
        if not np.isfinite(a).all():
            raise AssertionError(f"{k}: non-finite gradient")
        if not np.array_equal(a.view(np.int32), gp[k].view(np.int32)):
            raise AssertionError(f"{k}: two gradient steps differ")
    for k in ("geom.vertices", "geom.normals", "materials.diffuse", "camera.eye"):
        if not np.abs(ga[k]).sum() > 0:
            raise AssertionError(f"{k}: gradient is zero")
    log("[grad] every leaf finite; two steps equal bitwise on every leaf; "
        + ", ".join(f"{k} sum|g| {float(np.abs(ga[k]).sum()):.6g}"
                    for k in ("geom.vertices", "geom.normals", "materials.diffuse", "camera.eye")))

    def set_diffuse(s, leaf):
        return dataclasses.replace(s, materials=dataclasses.replace(s.materials, diffuse=leaf))

    ad, fd = G.fd_check(scene, gcfg, target, lambda s: s.materials.diffuse, set_diffuse,
                        torch.ones_like(scene.materials.diffuse), eps=1e-2, rtol=1e-3)
    log(f"[grad] fd_check materials.diffuse: ad {ad!r} fd {fd!r}")

    # 5c. Small input against the JAX package's gradient.
    gb = G.grad_scene(bscene, dataclasses.replace(bcfg, loop="scan", max_depth=2),
                      torch.zeros((bcfg.width * bcfg.height, 3), device=dev))
    stats = grad_stats(convert.grads_to_arrays(gb))
    for k in BUNNY_GRAD_REF:
        log(f"[bunny grad] {k}: sum, sum|x|, sum x^2 = {stats[k]} (JAX: {BUNNY_GRAD_REF[k]})")
    bad = bunny_grad_errors(stats)
    if bad:
        raise AssertionError("the bunny gradient disagrees with the JAX package: " + "; ".join(bad))
    verts = bscene.geom.vertices
    extent = float((verts.max(dim=0).values - verts.min(dim=0).values).max())
    zdir = torch.zeros_like(verts)
    zdir[:, 2] = 1.0

    def set_vertices(s, leaf):
        return dataclasses.replace(s, geom=refresh_tri_table(
            dataclasses.replace(s.geom, vertices=leaf)))

    ad, fd = G.fd_check(bscene, bcfg, torch.zeros((bcfg.width * bcfg.height, 3), device=dev),
                        lambda s: s.geom.vertices, set_vertices, zdir,
                        eps=1e-3 * extent, rtol=0.25)
    log(f"[bunny grad] agrees with JAX at rtol {BUNNY_GRAD_RTOL}; fd_check vertex "
        f"z-translation (eps {1e-3 * extent:.4g}): ad {ad!r} fd {fd!r}")

    # 5. Kernel and twin times at the main path's shapes (seeded frame).
    em = flat.emissions(rays, scene.tb, frame, seed_t=seed)
    args = frame_args(em, scene.tb)
    super_hits.hits2(*args, False)
    kernel_ms = cuda_events_ms(lambda: super_hits.hits2(*args, False), 50)
    super_hits.hits2_reference(*args, False)
    plain_ms = cuda_events_ms(lambda: super_hits.hits2_reference(*args, False), 2)
    em0 = em_closest
    args0 = frame_args(em0, scene.tb)
    kernel0_ms = cuda_events_ms(lambda: super_hits.hits2(*args0, False), 50)
    plain0_ms = cuda_events_ms(lambda: super_hits.hits2_reference(*args0, False), 2)
    log(f"[time] hits2 seeded frame: kernel {kernel_ms:.4f} ms, twin {plain_ms:.2f} ms; "
        f"unseeded frame: kernel {kernel0_ms:.4f} ms, twin {plain0_ms:.2f} ms; {card}")
    b2 = lambda: scatter_vn.segment_place(sids_d, svals_d, v_d)
    b2_twin = lambda: scatter_vn.segment_place_reference(sids_d, svals_d, v_d)
    b2()
    b2_twin()
    b2_ms = cuda_events_ms(b2, 20)
    b2_plain_ms = cuda_events_ms(b2_twin, 20)
    log(f"[time] segment_place dragon gradient stream (M={sids_d.shape[0]}, V={v_d}): "
        f"kernel {b2_ms:.4f} ms, twin {b2_plain_ms:.4f} ms; {card}")

    log(json.dumps({"kernels": [{
        "name": "super_hits.hits2",
        "route": "cuda",
        "source": "tracer_torch/csrc/super_hits.cu",
        "replaces": "tracer/kernels/super_hits.py:262",
        "launches": launches + g_launches["super_hits"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "scatter_vn.segment_place",
        "route": "cuda",
        "source": "tracer_torch/csrc/scatter_vn.cu",
        "replaces": "tracer/kernels/scatter_vn.py:109",
        "launches": g_launches["scatter_vn"],
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "plain_ms": b2_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

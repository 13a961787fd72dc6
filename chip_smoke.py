"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure, so the script exits non-zero):

1. probe    — a CUDA device must be visible; prints its name and power limit;
2. build    — compiles the super-tile hits kernel (``tracer_torch/csrc``)
              with nvcc for sm_90a;
3. kernel   — the kernel against its plain-PyTorch twin on the card, in both
              modes, on synthetic emissions (zero gate words, en < K, dead
              -3e38 windows) and on the emissions of a real dragon frame:
              ids equal and t equal bit for bit;
4. main     — ``Project: Dragon`` at 800x450 (the 869,880-triangle stand-in,
              native LBVH) through 1 warm-up and 20 timed
              ``progressive.step`` frames, then checks: every frame ran the
              kernel and never the twin, every lane converged, the
              accumulator is finite, miss pixels equal the background
              bitwise, and the frame's hit ids equal those of the same
              frame traced by the twin; a 64x48 ``Project: Bunny`` frame must
              also agree with the JAX package's render of it (summary
              numbers below).

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

import numpy as np
import torch

# The JAX package's render of Project: Bunny at 64x48, frame 0, on the CPU
# (tracer.render.integrator.render_sample): hit and miss pixel counts and
# the sum and sum of squares of the hit pixels' radiance. The stand-in's
# winding gives most lit pixels a negative Lambert cosine, which the
# reference keeps unclamped (project.wgsl), hence the negative sum.
BUNNY_REF = dict(hits=2908, misses=164, sum=-9860.647191603435,
                 sumsq=15683.204618622814)


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
    from tracer_torch.accel import flat
    from tracer_torch.kernels import super_hits
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    dev = tracer_torch.cuda_device()

    # 2. Build.
    t0 = time.perf_counter()
    _, build_log = super_hits.build()
    log(f"[build] super_hits.cu -> sm_90a in {time.perf_counter() - t0:.2f} s")
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
    super_hits.KERNEL_LAUNCHES = 0
    super_hits.REFERENCE_CALLS = 0
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

    log(json.dumps({"kernels": [{
        "name": "super_hits.hits2",
        "route": "cuda",
        "source": "tracer_torch/csrc/super_hits.cu",
        "replaces": "tracer/kernels/super_hits.py:262",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure, so the script exits non-zero):

1. probe    — a CUDA device must be visible; prints its name and power limit;
2. build    — compiles the three kernels (``tracer_torch/csrc``: super-tile
              hits B1, vertex-cotangent placement B2, treelet hits B3) with
              nvcc for sm_90a, in parallel, and prints their register and
              shared memory use;
3. kernel   — each kernel against its plain-PyTorch twin on the card. B1 and
              B3 in both modes, on synthetic emissions (``synthetic``,
              ``synthetic_tiles``: zero gate words, en = 0 and en < K, ids out
              of range, dead windows, a stream stopped by its entry
              distances, pre-occluded lanes; ``lane_tiles``: tiles with 1,
              31, 33 and 127 live lanes, a tile with emissions and no live
              lane, lanes that die mid-stream) and on real ones (a dragon
              frame for B1; bounce 2 of a W9 E1 frame and the occlusion
              probe of a W9 E2 frame for B3): ids equal and t equal bit for
              bit. B2 on synthetic streams (``scatter_streams``: M below
              one chunk and a multiple of it, segments on chunk edges and
              across many chunks, V = 1) and on the real stream of a dragon
              gradient step: two launches equal bitwise, equal bitwise to
              the twin run on a CPU copy (the same fixed chunk order), and
              within the float32 bound of a length-L sum of the twin on the
              card (atomics, no fixed order);
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
              steps and one under ``torch.profiler`` (kernels, device busy
              time, idle share, B1's and B2's device time), then checks:
              every step ran both kernels and neither
              twin, every gradient leaf is finite, the vertex, normal,
              diffuse and eye gradients are nonzero, two steps agree bit for
              bit on every leaf, and ``fd_check`` passes on the diffuse
              albedo; a 64x48 ``Project: Bunny`` gradient must agree with
              the JAX package's (``BUNNY_GRAD_REF``) and pass ``fd_check``
              on a rigid z-translation of its vertices;
6. path     — ``W9 E1 Bunny`` at 512x512 (path mode, depth 50, the 69,564-
              triangle stand-in, the seeded environment of ``seeded_env``
              for its missing HDRI) through 1 warm-up and 10 timed
              ``progressive.step`` frames: ms/frame and primary Mpath/s; then
              one frame with spies (bounces, B3 rounds per bounce, ray
              segments, phase A's device time, B3's time per launch) and
              one under ``torch.profiler`` (kernels, device busy time, idle
              share), and the live share of each of its B3 rounds.
              Checks: every frame ran B3 and never its twin, no lane
              was truncated, the accumulator is finite and non-negative,
              and a 32x32 frame agrees with the JAX package's numbers
              (``PATH_REF``). Then ``W9 E2 Bunny``, 1 warm-up and 3 frames:
              B3 must have run in any-hit mode (the holdout plane's
              occlusion probe);
7. times    — each kernel, its twin and (for B2) ``index_add_`` at the main
              paths' shapes by CUDA events, beside its bound (for B3 two:
              over the live lanes' tests, and over all 128 lanes of every
              visit); B2 also by the profiler's device time, and it must not
              be slower than ``index_add_``.

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


# The JAX package's render of W9 E1 Bunny at 32x32 (registry depth 50, the
# seeded environment of ``seeded_env``) after two progressive steps
# (tracer.render.progressive.step, on the CPU): the sum, the sum of squares
# and the largest value of the accumulator, in float64.
# ``tests/test_torch_path.py`` recomputes them from JAX, so they cannot go
# stale. The port's CPU render meets them at PATH_RTOL.
PATH_REF = dict(sum=96.71946799755096, sumsq=56.272532453645084, max=0.9304773807525635)
PATH_RTOL = 1e-4


def seeded_env(rgbe: bool, seed: int = 0, shape=(32, 64)) -> np.ndarray:
    """An (H, W, 4) float32 environment map of random 8-bit texels from
    numpy with a seed, standing in for the W9 rows' missing HDRIs; RGBE
    maps get shared exponents 2^-8 .. 2^7."""
    rs = np.random.RandomState(seed)
    env = (rs.randint(0, 256, (*shape, 4)) / 255.0).astype(np.float32)
    if rgbe:
        env[..., 3] = (rs.randint(120, 136, shape) / 255.0).astype(np.float32)
    return env


def path_stats(accum) -> dict:
    a = np.asarray(accum, np.float64)
    return dict(sum=float(a.sum()), sumsq=float((a * a).sum()), max=float(a.max()))


def path_errors(stats: dict, rtol: float = PATH_RTOL) -> list:
    """The statistics of ``stats`` that miss ``PATH_REF`` by more than
    ``rtol`` relative."""
    return [f"{k}: {stats[k]!r} vs {v!r}" for k, v in PATH_REF.items()
            if abs(stats[k] - v) > rtol * abs(v)]


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


def profiled_device_ms(fn, reps: int, key: str) -> float:
    """Mean device milliseconds per call of ``fn`` from ``torch.profiler``
    over ``reps`` calls: every kernel and memset the calls ran, without the
    host's enqueue, which sets the CUDA-event time of back-to-back calls of
    a short kernel. Raises unless a kernel whose name holds ``key`` ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not any(key in e.name for e in dev):
        raise AssertionError(f"the profiler saw no kernel named like {key!r}")
    return sum(e.time_range.end - e.time_range.start for e in dev) / 1e3 / reps


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


def _synthetic_scene(rs, device, n: int, plane: bool = False):
    """Random triangles in 3 treelets of 1024 (the last partly empty) and
    ``n`` rays from around (0, 0, 3) towards them: (tb, o, d, tmin,
    best_t) as numpy, the treelet table on ``device``. ``plane``: prim 0
    becomes a large triangle on z = 0 whose normal (0, 0, 1024) and plane
    constant 0 make t exact for rays along -z."""
    from tracer_torch.accel import treelet

    NT, T = 3, 1024
    ntri = NT * T - 100
    c = rs.uniform(-1.0, 1.0, (ntri, 1, 3)).astype(np.float32)
    c[:, :, 2] *= 0.3
    verts = (c + rs.normal(0.0, 0.08, (ntri, 3, 3))).astype(np.float32).reshape(-1, 3)
    if plane:
        verts[0:3] = [[-8.0, -8.0, 0.0], [24.0, -8.0, 0.0], [-8.0, 24.0, 0.0]]
    idx = np.arange(ntri * 3, dtype=np.int32).reshape(ntri, 3)
    pids = np.zeros((NT, T), np.int32)
    pids.reshape(-1)[:ntri] = rs.permutation(ntri)
    valid = np.arange(NT * T).reshape(NT, T) < ntri
    t = lambda x: torch.as_tensor(x, device=device)
    qblocks, qbox = treelet.assemble_blocks(t(verts), t(idx), t(pids), t(valid))
    tb = treelet.TreeletBvh(qblocks=qblocks, qbox=qbox, t_lo=t(np.zeros((NT, 3), np.float32)),
                            t_hi=t(np.zeros((NT, 3), np.float32)),
                            top=t(np.zeros((1, 8, 8), np.float32)), T=T, depth=1)
    o = np.float32([0.0, 0.0, 3.0]) + rs.normal(0.0, 0.05, (n, 3)).astype(np.float32)
    tgt = rs.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    tgt[:, 2] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = rs.uniform(0.0, 2.0, n).astype(np.float32)
    best_t = rs.uniform(2.5, 4.0, n).astype(np.float32)
    return tb, o, d, tmin, best_t


def synthetic(device, any_hit: bool, seed: int):
    """Random triangles in 3 treelets of 1024 (the last partly empty), two
    super-tiles, 12 emission slots with zero gate words, en < K, an id out of
    range, unordered entry distances and dead windows."""
    from tracer_torch.kernels.super_hits import SUPER

    rs = np.random.RandomState(seed)
    NT, n_super, KD = 3, 2, 12
    n = n_super * SUPER
    tb, o, d, tmin, best_t = _synthetic_scene(rs, device, n)
    t = lambda x: torch.as_tensor(x, device=device)
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


def synthetic_tiles(device, any_hit: bool, seed: int):
    """B3's inputs from numpy with a seed: the synthetic treelets above and 6
    tiles of 128 rays with 8 emission slots each; one tile with ``en = 0``,
    two with ``en < K``, ids out of range, a dead tile (the packet engine's
    padding: far origin, empty window), a tile whose entry distances stop
    its stream after two blocks, and in any-hit mode pre-occluded lanes and
    a tile occluded from the start. Returns (tb, eids, en, o, d, tmin,
    best_t, best_pid, enear)."""
    from tracer_torch.kernels.treelet_hits import TILE

    rs = np.random.RandomState(seed)
    n_tiles, K = 6, 8
    tb, o, d, tmin, best_t = _synthetic_scene(rs, device, n_tiles * TILE)
    sh = lambda x: torch.as_tensor(x.reshape(n_tiles, TILE, *x.shape[1:]), device=device)
    dead = slice(4 * TILE, 5 * TILE)
    o[dead], d[dead], tmin[dead], best_t[dead] = 1.0e30, 1.0, 1.0, 0.0
    best_pid = np.full(n_tiles * TILE, -1.0, np.float32)
    if any_hit:
        best_pid[rs.rand(n_tiles * TILE) < 0.1] = 1.0
        best_pid[3 * TILE:4 * TILE] = 1.0
    eids = rs.randint(0, tb.NT, (n_tiles, K)).astype(np.int32)
    eids[0, 2], eids[1, 0] = 99, -5
    eids[5] = [0, 0, 1, 2, 2, 1, 0, 1]  # the stream stops before blocks 1 and 2
    en = np.array([K, 5, 0, K, 3, K], np.int32)
    enear = np.zeros((n_tiles, K), np.float32)
    enear[5, 2:] = 5.0  # past every window top
    t = lambda x: torch.as_tensor(x, device=device)
    return (tb, t(eids), t(en), sh(o), sh(d), sh(tmin), sh(best_t), sh(best_pid), t(enear))


def lane_tiles(device, any_hit: bool, seed: int):
    """B3's inputs for the live-lane rule, from numpy with a seed: the
    synthetic treelets with prim 0 a large triangle on z = 0, and 6 tiles of
    128 rays with 8 emission slots each. Tiles 0-3 have 1, 31, 33 and 127
    live lanes and en = 8, 5, 8, 3; their other lanes have an empty window
    (tmin 5, best t 2) or, in any-hit mode, half of them are occluded
    instead. Tile 4 has emissions and no live lane (empty windows, 16 of
    them at +inf). In tile 5, 64 lanes start at z = 3 along -z with tmin 3:
    slot 2 emits the big triangle's treelet, which they hit at exactly
    t = 3, so closest lanes die there (bt reaches tmin); any-hit lanes die
    at their first hit. Returns the tuple of ``synthetic_tiles``; the
    closest-mode live tests are T x (1*8 + 31*5 + 33*8 + 127*3 + 128*3 +
    64*5)."""
    from tracer_torch.kernels.treelet_hits import TILE

    rs = np.random.RandomState(seed)
    n_tiles, K = 6, 8
    tb, o, d, tmin, best_t = _synthetic_scene(rs, device, n_tiles * TILE, plane=True)
    best_pid = np.full(n_tiles * TILE, -1.0, np.float32)
    for tile, n_live in enumerate((1, 31, 33, 127, 0)):
        dead = tile * TILE + np.sort(rs.permutation(TILE)[n_live:])
        occluded = dead[1::2] if any_hit else dead[:0]
        empty = np.setdiff1d(dead, occluded)
        tmin[empty], best_t[empty] = 5.0, 2.0
        best_pid[occluded] = 1.0
    tmin[4 * TILE:4 * TILE + 16] = best_t[4 * TILE:4 * TILE + 16] = np.inf
    axis = slice(5 * TILE, 5 * TILE + 64)
    o[axis, :2] = rs.uniform(-1.0, 1.0, (64, 2)).astype(np.float32)
    o[axis, 2], d[axis], tmin[axis], best_t[axis] = 3.0, [0.0, 0.0, -1.0], 3.0, 4.0
    q = tb.qblocks.cpu().numpy().reshape(tb.NT, -1, *tb.qblocks.shape[1:])
    holder = int(np.nonzero(((q[:, :, 9] == 0) & (q[:, :, 10] > 0.5)).any(axis=(1, 2)))[0][0])
    others = [b for b in range(tb.NT) if b != holder]
    eids = rs.randint(0, tb.NT, (n_tiles, K)).astype(np.int32)
    eids[5, :3] = [others[0], others[1], holder]
    en = np.array([K, 5, K, 3, K, K], np.int32)
    enear = np.zeros((n_tiles, K), np.float32)
    sh = lambda x: torch.as_tensor(x.reshape(n_tiles, TILE, *x.shape[1:]), device=device)
    t = lambda x: torch.as_tensor(x, device=device)
    return (tb, t(eids), t(en), sh(o), sh(d), sh(tmin), sh(best_t), sh(best_pid), t(enear))


def frame_args(em, tb):
    return (tb, em.ids, em.enear, em.en, em.gm, em.o, em.d, em.tmin, em.bt0, em.bp0)


def scatter_streams(seed: int, long_rows: int = 200_000):
    """Unsorted (name, ids (M,) int32, payload (M, 6) float32, V) vertex-
    cotangent streams from numpy with a seed: duplicates with untouched
    vertices (V = 1000, not a multiple of 512; M = 3001, not a multiple of
    anything), one segment of ``long_rows`` rows (spanning many chunks of
    ``scatter_vn.CHUNK_ROWS`` = 256) among short ones, V = 1, M below one
    chunk, M a multiple of it, and segments that start or end exactly on a
    chunk edge (once sorted: a segment of exactly chunk 1, one that starts
    on edge 2 and one that ends on edge 5)."""
    rs = np.random.RandomState(seed)
    out = []
    V, M = 1000, 3001
    ids = rs.randint(0, 700, M)  # vertices 700..999 and the gaps get no row
    out.append(("duplicates", ids, V))
    V = 777
    ids = np.concatenate([np.full(long_rows, 5), rs.randint(0, V, 4099)])
    out.append((f"segment of {long_rows}", rs.permutation(ids), V))
    out.append(("V = 1", np.zeros(513, np.int64), 1))
    out.append(("M below a chunk", rs.randint(3, 60, 200), 64))
    out.append(("M of 4 chunks", rs.randint(0, 300, 1024), 333))
    counts = [2] * 128 + [256, 300, 468] + [3] * 100  # rows 256-511, 512-811, 812-1279
    ids = np.repeat(np.arange(len(counts)), counts)
    out.append(("segments on chunk edges", rs.permutation(ids), 300))
    return [(name, ids.astype(np.int32),
             (rs.standard_normal((ids.shape[0], 6)) * rs.choice([1e-3, 1.0, 30.0], (ids.shape[0], 1))
              ).astype(np.float32), V)
            for name, ids, V in out]


def check_segment_place(name, sids, svals, V) -> float:
    """B2 against its twin on the card, for a sorted stream. Two launches
    must agree bitwise; the kernel must equal the twin run on a CPU copy
    (the same fixed chunk order) bitwise, and lie within L * 2^-23 * sum |x|
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


# The card's peaks for the bound of each kernel (the H100 SXM data sheet, at
# 700 W): device memory 3.35 TB/s; float32 outside the tensor cores
# 67 TFLOP/s. One Möller test (csrc/moller.cuh) is 38 float32 operations:
# 3 dot products of 5, 6 products and 3 differences for the cross product,
# 3 differences, 1 division, 1 subtraction and 3 products for t, beta and
# gamma, 1 negation and 1 sum for the inside test.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_TEST = 38


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work: the larger of its bytes over the memory
    rate and its operations over the float32 rate; and which one it is."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def b1_bound(args, visits: int) -> tuple[float, str]:
    """B1 on one set of emissions: every input read once (the quarter
    blocks that some live slot with a gate bit names), the output written
    once, and 128 x TQ tests per (sub-tile, quarter) visit of the twin."""
    tb, ids, enear, en, gm, o, d, tmin, bt, bp = args
    TQ = tb.qblocks.shape[2]
    live = (torch.arange(ids.shape[1], device=ids.device) < en[:, None]) & (gm != 0)
    blocks = ids.clamp(0, tb.qblocks.shape[0] - 1)[live].unique().numel() * 16 * TQ * 4
    n_bytes = blocks + nbytes(ids, enear, en, gm, o, d, tmin, bt, bp) + nbytes(bt, bp)
    return bound_ms(n_bytes, visits * 128 * TQ * OPS_PER_TEST)


def b3_bound(args, tests: int) -> tuple[float, str]:
    """B3 on one round: every input read once (the blocks that some slot
    below ``en`` names), the output written once, and ``tests`` Möller
    tests: 128 x T per (tile, block) visit of the twin (the bound over all
    lanes), or its ``live_tests`` (the bound over the work the function
    needs)."""
    tb, eids, en, o, d, tmin, bt, bp = args
    live = torch.arange(eids.shape[1], device=eids.device) < en[:, None]
    blocks = eids.clamp(0, tb.NT - 1)[live].unique().numel() * 16 * tb.T * 4
    n_bytes = blocks + nbytes(eids, en, o, d, tmin, bt, bp) + nbytes(bt, bp)
    return bound_ms(n_bytes, tests * OPS_PER_TEST)


def with_seeded_env(scene, desc, device):
    from tracer_torch.render import texture

    kind = texture.ENV_RGBE if desc.hdri_rgbe else texture.ENV_LDR
    env = torch.as_tensor(seeded_env(desc.hdri_rgbe), device=device)
    return dataclasses.replace(scene, env=texture.TextureBuf(data=env, kind=kind))


def instrumented_step(scene, cfg, state) -> dict:
    """One progressive step with spies on the path-mode layers: bounces,
    ray segments (lanes with a non-empty window at each bounce's trace),
    B3 rounds per bounce with their arguments, the CUDA-event span of each
    phase A call and each B3 call, phase A's host time (it ends on a host
    read of its loop condition, so the host clock brackets its device work
    too) against the whole step's, any-hit rounds and truncated lanes. The
    spies read the device, so this frame is not a timed one."""
    from tracer_torch.accel import packet
    from tracer_torch.render import integrator, progressive

    rec = dict(bounces=0, segments=0, rounds=[], bad=0, any_hit_rounds=0, phase_a_host_ms=0.0)
    ev_a, ev_b = [], []
    orig = (integrator.trace_closest, packet._phase_a_chunk, packet._dispatch_hits,
            integrator._paint_bad)

    def timed(fn, events):
        def run(*args, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            events.append((s, e))
            return out
        return run

    phase_a = timed(orig[1], ev_a)

    def phase_a_host(*args, **kw):
        t = time.perf_counter()
        out = phase_a(*args, **kw)
        rec["phase_a_host_ms"] += (time.perf_counter() - t) * 1e3
        return out

    def trace(sc, c, rays, *args, **kw):
        rec["bounces"] += 1
        rec["segments"] += int((rays.tmax > rays.tmin).sum())
        return orig[0](sc, c, rays, *args, **kw)

    b3 = timed(orig[2], ev_b)

    def dispatch(*args):
        rec["rounds"].append((rec["bounces"] - 1, args))
        rec["any_hit_rounds"] += int(bool(args[-1]))
        return b3(*args)

    def paint(result, bad):
        rec["bad"] += int(bad.sum())
        return orig[3](result, bad)

    integrator.trace_closest, packet._phase_a_chunk = trace, phase_a_host
    packet._dispatch_hits, integrator._paint_bad = dispatch, paint
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        progressive.step(scene, cfg, state)
        torch.cuda.synchronize()
        rec["frame_host_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        (integrator.trace_closest, packet._phase_a_chunk, packet._dispatch_hits,
         integrator._paint_bad) = orig
    rec["phase_a_ms"] = sum(s.elapsed_time(e) for s, e in ev_a)
    rec["b3_ms"] = [s.elapsed_time(e) for s, e in ev_b]
    return rec


def profile_step(step, keys: dict) -> dict:
    """One call of ``step`` under ``torch.profiler``: kernels, device busy
    time (the union of the device intervals), the traced span (first to
    last event of any kind) and the idle share of it; for each ``name:
    substring`` of ``keys``, the device time of the kernels whose name holds
    the substring, under ``name``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    out = dict(kernels=len(kernels), busy_ms=busy / 1e3, span_ms=span / 1e3,
               idle=1.0 - busy / span)
    for name, key in keys.items():
        out[name] = sum(e.time_range.end - e.time_range.start for e in dev if key in e.name) / 1e3
    return out


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
    from tracer_torch.kernels import scatter_vn, super_hits, treelet_hits
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    dev = tracer_torch.cuda_device()
    kernels = (super_hits, scatter_vn, treelet_hits)

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
    log("[kernel vs twin] B3 synthetic emissions")
    b3_err = 0.0
    for gen in (synthetic_tiles, lane_tiles):
        for any_hit in (False, True):
            for seed in (0, 1):
                *args, enear = gen(dev, any_hit, seed)
                b3_err = max(b3_err, compare(
                    f"B3 {gen.__name__} {'any-hit' if any_hit else 'closest'} seed {seed}",
                    treelet_hits.hits(*args, any_hit, enear=enear),
                    treelet_hits.hits_reference(*args, any_hit, enear=enear)))
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
    named = torch.unique(sids_d)
    runs = torch.diff(torch.cat([named.new_tensor([-1]), named, named.new_tensor([v_d])])) - 1
    log(f"[kernel vs twin] B2 dragon gradient stream: {named.numel()} of {v_d} vertices named, "
        f"{int(runs.sum())} not; longest unnamed runs {sorted(runs.tolist())[-3:]}")
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
    g_launches = {mod.__name__.split(".")[-1]: mod.KERNEL_LAUNCHES
                  for mod in (super_hits, scatter_vn)}
    g_ref_calls = sum(mod.REFERENCE_CALLS for mod in kernels)
    if treelet_hits.KERNEL_LAUNCHES:
        raise AssertionError("the gradient step ran the packet engine")
    ms_step = start.elapsed_time(end) / steps
    fb_mrays = 2 * cfg.width * cfg.height / (ms_step * 1e-3) / 1e6
    log(f"[grad] {steps} steps: {ms_step:.3f} ms/step (CUDA events), "
        f"{wall / steps * 1e3:.3f} ms/step (host clock), fwd+bwd {fb_mrays:.1f} Mray/s; {card}")
    log(f"[grad] kernel launches {g_launches} over {steps + 1} steps, twin calls {g_ref_calls}")
    if min(g_launches.values()) < steps + 1 or g_ref_calls != 0:
        raise AssertionError("the gradient step did not run on the kernels alone")
    gprof = profile_step(lambda: G.grad_scene(scene, gcfg, target),
                         {"b1_ms": "super_hits_kernel", "b2_ms": "_sums_kernel"})
    if gprof:
        log(f"[grad] profiled step: {gprof['kernels']} kernels, device busy "
            f"{gprof['busy_ms']:.3f} ms of a {gprof['span_ms']:.3f} ms trace (idle "
            f"{gprof['idle']:.1%}), B1 {gprof['b1_ms']:.4f} ms "
            f"({gprof['b1_ms'] / gprof['busy_ms']:.1%} of busy), B2's two kernels "
            f"{gprof['b2_ms']:.4f} ms ({gprof['b2_ms'] / gprof['busy_ms']:.1%}); {card}")
    else:
        log("[grad] the profiler recorded no device time")

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

    # 6. Path mode: W9 E1 Bunny at full registry size, seeded environment.
    pdesc = get_scene("W9 E1 Bunny")
    t0 = time.perf_counter()
    pscene, pcfg = build_scene(pdesc, dev)
    pscene = with_seeded_env(pscene, pdesc, dev)
    log(f"[path] {pdesc.name} {pcfg.width}x{pcfg.height}, max_depth {pcfg.max_depth}: "
        f"{pscene.geom.indices.shape[0]} triangles, {pscene.tb.NT} treelets, "
        f"built in {time.perf_counter() - t0:.2f} s")
    if (pcfg.width, pcfg.height, pcfg.max_depth) != (512, 512, 50) \
            or pscene.geom.indices.shape[0] != 69_564 or pcfg.mode != "path":
        raise AssertionError("the W9 E1 frame is not at full size")
    pstate = progressive.init_state(pcfg, dev)

    # 6a. Main path: 1 warm-up + 10 timed frames, every one through B3.
    reset_counts()
    per_frame = []
    progressive.step(pscene, pcfg, pstate)
    torch.cuda.synchronize()
    per_frame.append(treelet_hits.KERNEL_LAUNCHES)
    frames = 10
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        progressive.step(pscene, pcfg, pstate)
        per_frame.append(treelet_hits.KERNEL_LAUNCHES)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p_launches, p_ref = treelet_hits.KERNEL_LAUNCHES, treelet_hits.REFERENCE_CALLS
    if super_hits.KERNEL_LAUNCHES or scatter_vn.KERNEL_LAUNCHES:
        raise AssertionError("the path frame ran a direct-mode or gradient kernel")
    if min(np.diff([0] + per_frame)) < 1 or p_ref != 0:
        raise AssertionError(f"a path frame did not run on B3 alone (launches {per_frame}, "
                             f"twin calls {p_ref})")
    p_ms = start.elapsed_time(end) / frames
    log(f"[path] {frames} frames: {p_ms:.3f} ms/frame (CUDA events), "
        f"{wall / frames * 1e3:.3f} ms/frame (host clock), primary "
        f"{pcfg.width * pcfg.height / (p_ms * 1e3):.3f} Mpath/s; {card}")
    log(f"[path] B3 launches {p_launches} over {frames + 1} frames (cumulative {per_frame}), "
        f"twin calls {p_ref}")

    # 6b. One more frame with spies on the layers (not timed above).
    rec = instrumented_step(pscene, pcfg, pstate)
    n_rounds = len(rec["rounds"])
    log(f"[path] instrumented frame ({rec['frame_host_ms']:.3f} ms, host clock): "
        f"{rec['bounces']} bounces, {n_rounds} B3 rounds "
        f"({n_rounds / rec['bounces']:.2f} per bounce), {rec['segments']} ray segments "
        f"({rec['segments'] / (p_ms * 1e3):.3f} M segments/s at the timed ms/frame); phase A "
        f"{rec['phase_a_host_ms']:.3f} ms host clock "
        f"({rec['phase_a_host_ms'] / rec['frame_host_ms']:.1%} of the frame), "
        f"{rec['phase_a_ms']:.3f} ms CUDA-event span; "
        f"B3 calls {sum(rec['b3_ms']):.3f} ms in all, "
        f"{sum(rec['b3_ms']) / n_rounds:.4f} ms per launch; truncated lanes {rec['bad']}")
    if rec["bad"] or rec["any_hit_rounds"]:
        raise AssertionError("a lane was truncated, or W9 E1 ran an any-hit query")
    acc = pstate.accum
    if acc.shape != (pcfg.width * pcfg.height, 3) or not bool(torch.isfinite(acc).all()) \
            or not bool((acc >= 0).all()) or not float(acc.max()) > 0:
        raise AssertionError("path accumulator is not finite, non-negative and nonzero")
    if pstate.iteration != frames + 2:
        raise AssertionError(f"iteration {pstate.iteration} after {frames + 2} steps")

    # 6c. B3 against its twin on a real round: bounce 2 of that frame.
    (_, real), = [r for r in rec["rounds"] if r[0] == 1][:1]
    tb_r, eids_r, _, en_r, o_r, d_r, tmin_r, bt_r, bp_r, _ = real
    args_b3 = (tb_r, eids_r, en_r, o_r, d_r, tmin_r, bt_r, bp_r)
    log(f"[kernel vs twin] B3 W9 E1 bounce 2: {eids_r.shape[0]} tiles, "
        f"{float(en_r.float().mean()):.1f} blocks per tile (max {int(en_r.max())})")
    b3_err = max(b3_err, compare("B3 W9 E1 bounce 2 closest", treelet_hits.hits(*args_b3, False),
                                 treelet_hits.hits_reference(*args_b3, False)))
    log("[path] live share of lane-visits per round of the instrumented frame (the twin's "
        "live_tests over its visits x 128 x T), and visits of tiles with no live lane:")
    frame_st = {}
    for i, (bounce, rnd) in enumerate(rec["rounds"]):
        st = {}
        tb_i, eids_i, _, en_i, o_i, d_i, tmin_i, bt_i, bp_i, anyh = rnd
        treelet_hits.hits_reference(tb_i, eids_i, en_i, o_i, d_i, tmin_i, bt_i, bp_i, anyh,
                                    stats=st)
        for k, n in st.items():
            frame_st[k] = frame_st.get(k, 0) + n
        lanes = st["visits"] * 128 * tb_i.T
        log(f"  round {i} (bounce {bounce + 1}): {st['visits']} visits, live "
            f"{st['live_tests'] / max(lanes, 1):.2%}, {st['idle_visits']} with no live lane, "
            f"{rec['b3_ms'][i]:.4f} ms")
    log(f"  frame: {frame_st['visits']} visits, live "
        f"{frame_st['live_tests'] / max(frame_st['visits'] * 128 * tb_r.T, 1):.2%}, "
        f"{frame_st['idle_visits']} with no live lane")

    # 6d. The same frame under the profiler.
    prof = profile_step(lambda: progressive.step(pscene, pcfg, pstate),
                        {"b3_ms": "treelet_hits_kernel"})
    if prof:
        log(f"[path] profiled frame: {prof['kernels']} kernels, device busy "
            f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms trace (idle "
            f"{prof['idle']:.1%}), B3 {prof['b3_ms']:.3f} ms; {card}")
    else:
        log("[path] the profiler recorded no device time")

    # 6e. A 32x32 frame against the JAX package's numbers.
    sdesc = dataclasses.replace(pdesc, cfg=dataclasses.replace(pdesc.cfg, width=32, height=32))
    sscene, scfg = build_scene(sdesc, dev)
    sst = progressive.render_progressive(with_seeded_env(sscene, sdesc, dev), scfg, 2)
    stats = path_stats(sst.accum.cpu().numpy())
    log(f"[path 32x32] {stats} (JAX: {PATH_REF})")
    bad = path_errors(stats)
    if bad:
        raise AssertionError("the 32x32 path frame disagrees with the JAX package: " + "; ".join(bad))

    # 6f. W9 E2 Bunny (the holdout plane's occlusion probe): 1 + 3 frames.
    edesc = get_scene("W9 E2 Bunny")
    escene, ecfg = build_scene(edesc, dev)
    escene = with_seeded_env(escene, edesc, dev)
    estate = progressive.init_state(ecfg, dev)
    reset_counts()
    progressive.step(escene, ecfg, estate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(3):
        progressive.step(escene, ecfg, estate)
    end.record()
    torch.cuda.synchronize()
    e_wall = time.perf_counter() - t0
    e_launches, e_ref = treelet_hits.KERNEL_LAUNCHES, treelet_hits.REFERENCE_CALLS
    e_ms = start.elapsed_time(end) / 3
    if e_launches < 4 or e_ref != 0:
        raise AssertionError("the W9 E2 frames did not run on B3 alone")
    erec = instrumented_step(escene, ecfg, estate)
    log(f"[path E2] {ecfg.width}x{ecfg.height}, 3 frames: {e_ms:.3f} ms/frame (CUDA events), "
        f"{e_wall / 3 * 1e3:.3f} ms/frame (host clock); B3 launches {e_launches} over 4 "
        f"frames, twin calls {e_ref}; instrumented frame: {erec['bounces']} bounces, "
        f"{len(erec['rounds'])} B3 rounds of which {erec['any_hit_rounds']} any-hit, phase A "
        f"{erec['phase_a_host_ms']:.3f} of {erec['frame_host_ms']:.3f} ms (host clock), "
        f"truncated lanes {erec['bad']}; {card}")
    if not erec["any_hit_rounds"] or erec["bad"]:
        raise AssertionError("W9 E2 ran no any-hit round of B3, or truncated a lane")
    if not bool(torch.isfinite(estate.accum).all()) or not bool((estate.accum >= 0).all()):
        raise AssertionError("the W9 E2 accumulator is not finite and non-negative")
    (_, real_any), = [r for r in erec["rounds"] if r[1][-1]][:1]
    args_any = tuple(real_any[i] for i in (0, 1, 3, 4, 5, 6, 7, 8))
    b3_err = max(b3_err, compare("B3 W9 E2 occlusion probe any-hit",
                                 treelet_hits.hits(*args_any, True),
                                 treelet_hits.hits_reference(*args_any, True)))

    # 7. Kernel, twin and library times at the main paths' shapes.
    em = flat.emissions(rays, scene.tb, frame, seed_t=seed)
    args = frame_args(em, scene.tb)
    super_hits.hits2(*args, False)
    kernel_ms = cuda_events_ms(lambda: super_hits.hits2(*args, False), 50)
    b1_stats = {}
    super_hits.hits2_reference(*args, False, stats=b1_stats)
    plain_ms = cuda_events_ms(lambda: super_hits.hits2_reference(*args, False), 2)
    b1_bound_ms, b1_by = b1_bound(args, b1_stats["visits"])
    em0 = em_closest
    args0 = frame_args(em0, scene.tb)
    kernel0_ms = cuda_events_ms(lambda: super_hits.hits2(*args0, False), 50)
    plain0_ms = cuda_events_ms(lambda: super_hits.hits2_reference(*args0, False), 2)
    log(f"[time] hits2 seeded frame: kernel {kernel_ms:.4f} ms, twin {plain_ms:.2f} ms, "
        f"bound {b1_bound_ms:.4f} ms ({b1_by}; {b1_stats['visits']} sub-tile x quarter tests); "
        f"unseeded frame: kernel {kernel0_ms:.4f} ms, twin {plain0_ms:.2f} ms; {card}")
    b2 = lambda: scatter_vn.segment_place(sids_d, svals_d, v_d)
    b2_twin = lambda: scatter_vn.segment_place_reference(sids_d, svals_d, v_d)
    sids_l = sids_d.long()
    b2_lib = lambda: torch.zeros((v_d, 6), dtype=torch.float32, device=dev).index_add_(
        0, sids_l, svals_d)
    b2()
    b2_twin()
    b2_lib()
    b2_ms = cuda_events_ms(b2, 100)
    b2_device_ms = profiled_device_ms(b2, 100, "chunk_sums_kernel")
    b2_plain_ms = cuda_events_ms(b2_twin, 20)
    b2_lib_ms = cuda_events_ms(b2_lib, 20)
    m_rows = sids_d.shape[0]
    b2_bound_ms, b2_by = bound_ms(m_rows * (4 + 24) + v_d * 24, m_rows * 6)
    log(f"[time] segment_place dragon gradient stream (M={m_rows}, V={v_d}): "
        f"kernel {b2_ms:.4f} ms per call (CUDA events; device time {b2_device_ms:.4f} ms by "
        f"the profiler), twin {b2_plain_ms:.4f} ms, index_add_ {b2_lib_ms:.4f} ms, bound "
        f"{b2_bound_ms:.4f} ms ({b2_by}); {card}")
    if b2_ms > b2_lib_ms:
        raise AssertionError("B2 is slower than index_add_")
    treelet_hits.hits(*args_b3, False)
    b3_ms = cuda_events_ms(lambda: treelet_hits.hits(*args_b3, False), 20)
    b3_stats = {}
    treelet_hits.hits_reference(*args_b3, False, stats=b3_stats)
    b3_plain_ms = cuda_events_ms(lambda: treelet_hits.hits_reference(*args_b3, False), 2)
    b3_all_ms, b3_all_by = b3_bound(args_b3, b3_stats["visits"] * 128 * tb_r.T)
    b3_bound_ms, b3_by = b3_bound(args_b3, b3_stats["live_tests"])
    log(f"[time] treelet_hits W9 E1 bounce 2 round: kernel {b3_ms:.4f} ms, twin "
        f"{b3_plain_ms:.2f} ms, bound over live tests {b3_bound_ms:.4f} ms ({b3_by}; "
        f"{b3_stats['live_tests']} tests, {b3_stats['live_tests'] / (b3_ms * 1e9):.3f} "
        f"T live Moller tests/s), bound over all lanes {b3_all_ms:.4f} ms ({b3_all_by}; "
        f"{b3_stats['visits']} tile x block visits x 128 x {tb_r.T}); {card}")

    log(json.dumps({"kernels": [{
        "name": "super_hits.hits2",
        "route": "cuda",
        "source": "tracer_torch/csrc/super_hits.cu",
        "replaces": "tracer/kernels/super_hits.py:262",
        "launches": launches + g_launches["super_hits"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b1_bound_ms,
        "bound_by": b1_by,
        "library_ms": None,
    }, {
        "name": "scatter_vn.segment_place",
        "route": "cuda",
        "source": "tracer_torch/csrc/scatter_vn.cu",
        "replaces": "tracer/kernels/scatter_vn.py:109",
        "launches": g_launches["scatter_vn"],
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "device_ms": b2_device_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_by,
        "library_ms": b2_lib_ms,
    }, {
        "name": "treelet_hits.hits",
        "route": "cuda",
        "source": "tracer_torch/csrc/treelet_hits.cu",
        "replaces": "tracer/kernels/treelet_hits.py:160",
        "launches": p_launches + e_launches,
        "max_abs_err": b3_err,
        "ms": b3_ms,
        "plain_ms": b3_plain_ms,
        "bound_ms": b3_bound_ms,
        "bound_by": b3_by,
        "bound_all_lanes_ms": b3_all_ms,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

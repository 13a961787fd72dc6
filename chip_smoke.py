"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure, so the script exits non-zero):

1. probe    — a CUDA device must be visible; prints its name and power limit;
2. build    — compiles the seven kernels (``tracer_torch/csrc``: super-tile
              hits B1, vertex-cotangent placement B2, treelet hits B3,
              B1's any-hit query ``super_occluded``, packet phase A's walk,
              the brute-force engine's ``brute_hits`` and the texel-cotangent
              placement ``texel_place``) with nvcc for sm_90a,
              in parallel, and prints their register and shared memory use;
3. kernel   — each kernel against its plain-PyTorch twin on the card. B1 and
              B3 in both modes, on synthetic emissions (``synthetic``,
              ``synthetic_tiles``: zero gate words, en = 0 and en < K, ids out
              of range, dead windows, a stream stopped by its entry
              distances, pre-occluded lanes; ``super_lanes`` for B1, at
              TQ = 256 and 8: sub-tiles with 1, 31, 33 and 127 live lanes,
              gate words of 1, 2, 15 and 16 bits, +inf bounds, the repair
              pass's mostly dead lanes, lanes that die mid-stream, a stream
              stopped by its bounds under unordered entry distances, en
              above K and en = 0; ``lane_tiles`` for B3: tiles with 1,
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
              card (atomics, no fixed order). The any-hit query's kernel on
              ``OCCLUSION_CASES`` (a bumpy blob, quarters of 8, 64 and 256
              triangles, overflowing super-tiles, sweeps cut by the round
              cap, lanes blocked before the query, dead windows, rays that
              graze quarter-box faces, edges and corners, rays at cos
              2^-16 to 2^-24 to a triangle's normal aimed just outside its
              quarter's box): flags, t and converged equal to the plain
              twin route's (whose sweep is ungated) bit for bit, two
              launches equal, and the kernel's sweep gates equal to
              ``sweep_gates`` on every (sub-tile, quarter) pair;
4. frame    — ``Project: Dragon`` at 800x450 (the 869,880-triangle stand-in,
              native LBVH) through 1 warm-up and 20 timed
              ``progressive.step`` frames, then checks: every frame ran B1
              and never its twin, every lane converged, the accumulator is
              finite, miss pixels equal the background bitwise, and the
              frame's hit ids equal those of the same frame traced by the
              twin; one more frame under ``torch.profiler`` (kernels,
              device busy time, idle share, B1's device time); a 64x48
              ``Project: Bunny`` frame must also agree with the JAX
              package's render of it (summary numbers below);
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
              paths' shapes by CUDA events, beside its bound, and B1's work
              on the seeded dragon frame as its twin counts it (staged
              slots, rounds, visits, live tests, rounds and visits per
              super-tile; for B3 two bounds:
              over the live lanes' tests, and over all 128 lanes of every
              visit); B2 also by the profiler's device time, and it must not
              be slower than ``index_add_``; ``texel_place`` on one 512x512
              W9 E1 lookup (``texel_stream``: 1,048,576 rows onto 2,048
              texels, crowded as a first bounce's camera rays) checked
              against its twin bitwise, then kernel (events and the
              profiler), byte bound, twin, the whole backward it serves
              (sort, permutation, kernel) and PyTorch's index backward,
              ``index_put_(accumulate=True)``, which it must beat;
8. cornell  — ``W8 E3 Absorption`` at 512x512 (path mode, depth 10, the
              12-triangle Cornell box of ``with_fixture_model``, two
              spheres, next-event estimation over the light quad, the
              dielectric with absorption), which takes the brute-force
              engine (its kernel ``brute_hits``, one launch a query), through 1
              warm-up and 10 timed ``progressive.step`` frames: ms/frame by
              CUDA events and by the host clock and primary Mpath/s; one
              frame with spies (bounces, ray segments and shadow rays) and
              one under ``torch.profiler`` (kernels, device busy time, idle
              share); the brute-force engine's closest-hit and any-hit
              queries of bounce 2 alone, kernel and twin, by CUDA events and
              the profiler, beside their bound. Checks: no lane was
              truncated, the accumulator is finite and non-negative, every
              brute-force pair of the timed frames ran in the kernel, one
              launch a query in the instrumented frame, no other hand kernel
              and no twin ran, the kernel equals its twin bit for bit on
              bounce 2's queries, and a
              32x32 frame agrees with the JAX package's numbers
              (``CORNELL_REF``). Then ``W8 E1`` and ``W8 E2 Cornell Box
              Balls`` at 512x512 and ``W7 E3 Cornell Box`` at 128x128, 1
              warm-up and 3 frames each (ms/frame), with the same checks;
9. pgrad    — path-mode gradients (``grad_scene``, ``loop="scan"``, target
              zeros). ``W8 E3 Absorption`` at 512x512, depth 10, remat
              "none": 1 warm-up and 3 timed steps (ms/step by CUDA events and
              the host clock, paths/s, peak allocated memory), one step with
              a spy (bounces) and one under ``torch.profiler`` (kernels,
              device busy time, idle share; the forward alone is profiled
              apart, which gives the backward's share of busy time), and one
              timed ``remat="full"`` step beside it. Checks: every leaf
              finite, the diffuse, emission, vertex, sphere-center and eye
              gradients nonzero, two steps (and the remat step) equal bit
              for bit, no hand kernel but ``brute_hits`` and no twin
              launched, ``fd_check`` on
              the diffuse albedo at 64x64, and a 16x16 gradient against the
              JAX package's numbers (``CORNELL_GRAD_REF``). Then ``W9 E1
              Bunny`` at 256x256 (cut from 512x512), depth 50, seeded
              environment: 1 warm-up and 2 timed steps (ms/step, peak
              memory), bounces, B3's and B2's launches and B2's rows per
              launch; checks that B3 ran on every bounce, B2 once per
              bounce but the last (whose rows reach nothing that the loss
              reads) and ``texel_place`` once per bounce on 4 taps of every
              lane, no twin ran, every leaf is finite and two steps agree
              bit for bit, and holds B2 against its twin on bounce 2's
              sorted corner stream of the path lanes (with its real
              cotangents and with seeded ones on the same ids) and
              ``texel_place`` against its twin on bounce 1's lookup;
10. direct  — direct mode. ``W6 E1 Dragon`` (the ``mix_ka`` ambient) on
              phase 4's built dragon (the descriptors differ in their
              configuration only, which is checked first), 1 warm-up and 10
              timed frames (ms/frame by CUDA events and the host clock), one
              instrumented and one profiled: B1 on every frame, never its
              twin, and the frame's hit ids equal phase 4's ``Project:
              Dragon`` ids bit for bit. The shadowed dragon
              (``with_standin_mesh``: W5 E3's ``directional`` light with
              shadow rays, the ``mix`` ambient) the same way, its shadow
              rays through the any-hit query's kernel on every frame: every
              frame's query (14) afterwards held bitwise to the twin route
              on B1's kernel, and the last one's also to the plain twin
              route on all 360,000 shadow rays (every lane converged),
              whose counts give the
              query's live tests and bound; the kernel timed against the
              old route (B1 over the culled list, then 16 id-order rounds)
              on those rays, its bound over its own live tests (the
              ``kernels`` line's ``bound_ms``) and over the twin route's,
              its sweep gates (the kernel's device function) equal to
              ``sweep_gates`` on every (sub-tile, quarter) pair and the
              share of the sweep's pairs they leave open,
              B1 bitwise equal to its twin on their culled emissions in
              any-hit mode, and the list alone (round cap 1) through the
              kernel, held to and timed against B1's any-hit launch. ``W6 E3 Cornell Box`` at 512x512 (mirror, glossy,
              the area lights; brute force) 1 + 10 frames with spies
              (bounces, shadow rays); ``W5 E4``/``E5``, ``W6 E2``, ``W7
              E1``/``E2`` and W1 E1-W3 E4 at 512x512, 1 + 3 frames each.
              Checks on every run: every lane converged, the accumulator is
              finite, no hand kernel or twin ran where none should; and
              32x32 frames meet the JAX package's numbers (``DIRECT_REF``).

11. sun     — ``W9 E3 Teapot`` on the bunny stand-in (``sun_desc``: the
              teapot is missing and has no stand-in; the seeded environment
              for its missing JPEG) at its registry 800x450 and depth 50:
              path mode with the sun's next-event estimation. 1 warm-up and
              3 timed frames (ms/frame by CUDA events and the host clock),
              one with spies (bounces, ray segments, shadow rays, B3's
              closest-hit and any-hit rounds) and one under
              ``torch.profiler``; B3 against its twin on a real any-hit
              round. Checks: every frame ran B3 and never its twin, no
              truncated lane, a finite non-negative accumulator, and 32x32
              frames of the row and of ``with_lit_plane`` equal on the card
              and the CPU bit for bit and meet the JAX package's numbers
              (``SUN_REF``);
12. cli     — ``tracer_torch.cli.main`` in process on ``Project: Dragon``
              at 800x450 (B1) with a fresh ``TRACER_SCENE_CACHE``: 8 frames
              straight (cold cache), 4 with ``--checkpoint`` (warm), then
              ``--resume`` to 8: the two ``--out-npz`` images bitwise
              equal, the time to first frame cold and warm with the build's
              stages, the ``--out`` PNG decoded by the port's reader equal
              to the display image rounded to 8 bits; ``--interactive`` over
              a pipe (child process) on ``W1 E6``; ``--sharded`` (a group of
              one rank) straight to 8 and checkpointed 4 + resumed 4, each
              ``--out-npz`` bitwise equal to the unsharded image;
13. hdr     — ``W9 E2 Bunny`` at 64x64 with ``tests/fixtures/tiny_env.hdr.png``
              as its environment, read by the build's RGBE loader: two
              frames, the card's accumulator equal to the CPU's bit for bit;
14. dgrad   — direct-mode gradients (``grad_scene``, target zeros).
              ``W6 E1 Dragon`` (the ``mix_ka`` ambient) on phase 4's dragon
              at 800x450: 1 warm-up and 5 timed steps (ms/step by CUDA
              events and the host clock, peak memory) and one under
              ``torch.profiler`` (kernels, busy, idle, B1's and B2's device
              time); every step ran B1 and B2 and neither twin, every leaf
              is finite, the vertex, normal, diffuse and eye leaves are
              nonzero, two steps agree bit for bit, and ``fd_check`` passes
              on the diffuse albedo. The shadowed dragon (W5 E3's
              configuration on the stand-in, as phase 10): 1 warm-up and 2
              timed steps, the any-hit query's kernel in each (each step's
              query held bitwise to the twin route on B1's kernel). One step each (after
              one) of ``W5 E5`` and ``W6 E3 Cornell Box`` and ``W3 E3``
              (16 sub-samples, ``seeded_texture`` on the plane that
              ``with_textured_plane`` marks textured) at 512x512, with no
              hand kernel; each of those rows at 32x32 on the card against
              the port's CPU gradient of the same inputs
              (``DGRAD_CARD_RTOL``);
15. walk    — the BSP walk (``bsp_execution="walk"``) and the ``bvh2`` walk
              on ``Project: Bunny BSP`` at 512x512: build time, 1 warm-up
              and 2 timed frames each (ms/frame, walk steps per frame), no
              hand kernel, and the primary rays' hit ids against the
              treelet engine's (B1); then W9 E1's bounce-2 mesh query
              (512x512, the seeded environment) through both walks beside
              packet + B3 on the same rays: ms per query, steps, and ids
              against packet + B3's (at most ``WALK_MAX_DIFFER`` of the
              lanes may differ, each at an equal t: a tie on a shared
              edge);
16. shard   — ``tracer_torch.parallel`` on a one-rank NCCL group: the
              dragon through 1 + 3 ``sharded_step`` frames (B1 every frame,
              never its twin; the gathered accumulator bitwise equal to 4
              single-device frames) and 1 + 2 ``grad_scene_sharded`` steps
              (B1 and B2 every step; each bitwise equal to ``grad_scene``),
              ms/frame and ms/step by CUDA events beside phases 4 and 5;
              then, in one process, the dragon frame and W9 E1's 512x512
              frame rendered as 2 and 3 bands of rows and assembled, each
              bitwise equal to the whole frame (B3 in every W9 E1 band);
17. oracle  — the card's frames of ``ORACLE_CASES`` (the rows of
              ``tests/test_oracle_parity.py`` whose assets exist, at 24x24
              or 16x16: W1 E6, W1 E4, the W2 selections, W5 E2 and W6 E1 on
              the bunny stand-in, W5 E5, W8 E3 at iterations 0, 1 and 3, W3
              E3/E4 untextured and with ``seeded_texture``, W9 E1/E2 with
              ``seeded_env``) against the port's CPU oracle at that file's
              thresholds, or, where the JAX package's own renderer scores
              below them, at its score (``ORACLE_JAX_SCORES``): the card's
              first check that does not run through the port's renderer;
18. jpeg    — ``tests/fixtures/texture_{420,grey,progressive}.jpg``
              decoded on the host (ms beside the file's size), each equal to
              the PIL decode stored beside it; ``W3 E3`` at 512x512 with the
              4:2:0 fixture on the plane ``with_textured_plane`` marks
              textured: 2 frames, the card's accumulator equal to the CPU's
              bit for bit;
19. bvh8    — ``Project: Bunny BSP`` with ``traversal="bvh8"`` at 512x512:
              build time, 1 + 2 frames (ms/frame), no hand kernel and no
              twin, the primary rays' ids against the treelet engine's (B1;
              ``WALK_MAX_DIFFER``, ties at an equal t); then W9 E1's bounce-2
              query by packet + B3, the ``bvh2`` walk and the ``bvh8`` walk
              (ms per query; bvh8's ids against packet + B3's).

B1's ``launches`` count the timed frames and steps of phases 4, 5, 10, 14
and 16 and the CLI's frames of phase 12; B2's the steps of phases 5, 9, 14
and 16; B3's the frames and steps of phases 6, 9 and 11 and the 3-band W9
E1 frame of phase 16; the any-hit query's the shadowed dragon's counted
frames of phase 10 and steps of phase 14 (its ``max_abs_err`` counts
lanes that differ from the plain twin route); the brute-force kernel's the
queries of phase 8's timed frames (graph replays, counted by
``brute.kernel_pairs``); ``texel_place``'s the W9 E1 steps of phase 9.

Prints one JSON object of per-kernel results on the line before the last,
and ``{"ok": true, "device": {...}}`` as the last line. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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

# The same numbers for W8 E3 Absorption at 32x32 (registry depth 10, the
# Cornell box of ``with_fixture_model``) after two progressive steps.
# ``tests/test_torch_cornell.py`` recomputes them from JAX. The port's CPU
# render meets them at 2.3e-5 relative at worst (the sum: the per-pair
# Möller test and float64 transcendentals send a few lanes down another
# path than the JAX package's matrix-form test and float32 ones), inside
# CORNELL_RTOL with a margin of 4x; the card's render equals the CPU's bit
# for bit.
CORNELL_REF = dict(sum=690.4276269679613, sumsq=6906.90693658513, max=39.46552276611328)
CORNELL_RTOL = 1e-4

# The same numbers for direct rows at 32x32 (registry configs, the Cornell
# box of ``with_fixture_model``; W3 E3's grass.jpg is missing, so its plane
# keeps its base colour): the point light without and with shadow rays and
# the mirror (W1 E6, W2 E2), the transmit (W2 E5), 4x4 stratified jitter
# (W3 E3), and the area lights with the mirror and the glossy sphere (W6
# E3). ``tests/test_torch_direct.py`` recomputes them from JAX. The port's
# CPU render meets them at 2.8e-7 relative at worst (W6 E3's sum), inside
# DIRECT_RTOL with a margin of 36x.
DIRECT_REF = {
    "W1 E6": dict(sum=581.2844606656581, sumsq=376.2305237873462, max=1.8786534070968628),
    "W2 E2": dict(sum=515.3050512839109, sumsq=264.28176614903657, max=1.2816846370697021),
    "W2 E5": dict(sum=512.0128997592255, sumsq=264.4717487768444, max=1.2816846370697021),
    "W3 E3": dict(sum=481.7910443585133, sumsq=237.0962015433538, max=1.2090566158294678),
    "W6 E3 Cornell Box": dict(sum=593.5132094046579, sumsq=8756.00612299916,
                              max=27.600000381469727),
}
DIRECT_RTOL = 1e-5

# The JAX package's path-mode gradient of W8 E3 Absorption at 16x16
# (tracer.diff.grad.grad_scene with loop="scan", registry depth 10, target
# zeros, one sample, on the CPU): per leaf (sum, sum of |x|, sum of x^2) in
# float64, as BUNNY_GRAD_REF. ``tests/test_torch_path_grad.py`` recomputes
# them from JAX. Not 32x32: there the JAX package's gradient is NaN on every
# leaf that the camera and geometry reach (a lane's 0 x inf in its
# backward; the port's is finite), which that test also holds.
CORNELL_GRAD_REF = {
    "camera.eye": (-0.001508608111180365, 0.007523425971157849, 2.2089079535796296e-05),
    "camera.target": (0.0006278645014390349, 0.012295853928662837, 7.579111747525758e-05),
    "camera.up": (0.3158331513404846, 0.3158331513404846, 0.09975057948566146),
    "camera.constant": (-1.2127290964126587, 1.2127290964126587, 1.4707118612858636),
    "camera.aspect": (0.7801536321640015, 0.7801536321640015, 0.6086396897786841),
    "geom.vertices": (-0.0030979987592879214, 0.009339761012756465, 8.531555513393352e-06),
    "materials.diffuse": (0.1304906071163714, 0.25911700120195746, 0.0169910541338914),
    "materials.emission": (0.5281694909208454, 0.5281694909208454, 0.04878203152946211),
    "spheres.center": (0.003978742983447248, 0.004036960878410767, 9.286682899993443e-06),
    "spheres.radius": (0.0022303962132568245, 0.0022305406646196957, 4.974989462316228e-06),
    "spheres.ior": (2.2453364181274083e-06, 2.2453364181274083e-06, 5.0415356305692195e-12),
    "spheres.extinction": (-2.0552236264848034e-05, 6.768842399651476e-05, 2.411582938374381e-09),
}
CORNELL_GRAD_ZERO = ("geom.normals", "geom.tri_table", "materials.specular",
                     "materials.shininess", "materials.ior", "spheres.base_color")
CORNELL_GRAD_RTOL = 1e-4


# The JAX package's render of W9 E3 Teapot at 32x32 (registry depth 50, the
# sun's next-event estimation) on the bunny stand-in (``with_standin_mesh``;
# the teapot is missing) with the seeded environment of ``seeded_env`` (the
# JPEG is missing) after two progressive steps, as PATH_REF: the row as it
# is (its holdout plane), and with that plane a grey Lambertian
# (``with_lit_plane``), where the sun lights the plane and the bunny casts
# its shadow on it. ``tests/test_torch_sun.py`` recomputes them from JAX.
SUN_REF = {
    "row": dict(sum=626.052849235246, sumsq=366.4213899333887, max=0.9628999829292297),
    "lit plane": dict(sum=1448.4777939936612, sumsq=2540.1077467989094,
                      max=3.8571970462799072),
}
SUN_RTOL = PATH_RTOL

# The card's direct-mode gradient against the port's CPU gradient of the
# same inputs at 32x32 (phase 14): allclose at this rtol with an atol of
# 1e-4 of each leaf's largest magnitude. The forward frames are bitwise
# equal on the two devices; autograd's reductions (over lanes into the
# camera, the materials' one-hot products, the texels' gathers) sum in
# other orders there.
DGRAD_CARD_RTOL = 1e-4
# Phase 15: lanes of a walk's frame whose hit id may differ from the
# treelet engine's (both hit one triangle's shared edge: a tie of t).
WALK_MAX_DIFFER = 0.001
# Phase 17: the JAX package's renderer against its own oracle on the
# textured W3 cases of ``ORACLE_CASES`` (share of matching pixels at 24x24,
# CPU; ``tests/test_torch_oracle.py`` recomputes them): below the 0.999 of
# ``tests/test_oracle_parity.py``, so the port's score must reach these.
ORACLE_JAX_SCORES = {"W3 E3 textured": 0.9722222222222222,
                     "W3 E4 textured nearest": 0.9739583333333334}


def seeded_env(rgbe: bool, seed: int = 0, shape=(32, 64)) -> np.ndarray:
    """An (H, W, 4) float32 environment map of random 8-bit texels from
    numpy with a seed, standing in for the W9 rows' missing HDRIs; RGBE
    maps get shared exponents 2^-8 .. 2^7."""
    rs = np.random.RandomState(seed)
    env = (rs.randint(0, 256, (*shape, 4)) / 255.0).astype(np.float32)
    if rgbe:
        env[..., 3] = (rs.randint(120, 136, shape) / 255.0).astype(np.float32)
    return env


def seeded_texture(seed: int = 0, shape=(16, 16)) -> np.ndarray:
    """An (H, W, 4) float32 plane texture of random 8-bit texels from numpy
    with a seed, standing in for the W3 rows' missing ``grass.jpg``."""
    return seeded_env(False, seed, shape)


def with_standin_mesh(desc, model: str = "dragon.obj"):
    """``desc`` (a descriptor of either package's registry) with its model
    pointed at the registry path of a mesh that has a procedural stand-in
    and the camera on it (``DRAGON_CAM``, the bunny's, at the row's
    aspect). On ``W5 E3 Teapot`` (the ``directional`` light with shadow
    rays, the ``mix`` ambient) this is the shadowed direct frame on a large
    mesh: both packages substitute the stand-in where the teapot is
    missing. A test configuration, not a registry row."""
    from tracer_torch.scenes.registry import DRAGON_CAM, REF_RES

    return dataclasses.replace(
        desc, name=f"{desc.name} on {model}", model=f"{REF_RES}/models/{model}",
        camera=dict(DRAGON_CAM, aspect=desc.camera["aspect"]))


def with_lit_plane(desc):
    """``desc`` with its planes made grey Lambertians (shader 0, base colour
    0.8): on ``W9 E3`` the sun then lights the plane, and the shadow rays
    from it are blocked where the mesh's shadow falls (the stand-ins'
    normals point into the mesh, so the mesh itself is never lit by the
    sun). A test configuration, not a registry row."""
    planes = tuple((p[0], p[1], p[2], p[3], 0, (0.8, 0.8, 0.8), p[6]) for p in desc.planes)
    return dataclasses.replace(desc, name=f"{desc.name}, lit plane", planes=planes)


def with_textured_plane(desc):
    """``desc`` with its planes marked textured. Both registries build the
    W3 rows' plane untextured (``_w1_analytics``' ``textured=False``), so
    a bound texture never shows there; with this the plane samples it, and
    ``texture.data`` and ``uniforms.uv_scale`` get gradients. A test
    configuration, not a registry row."""
    planes = tuple(p[:6] + (True,) for p in desc.planes)
    return dataclasses.replace(desc, name=f"{desc.name}, textured plane", planes=planes)


def sun_desc(get_scene, lit: bool = False, size=None):
    """``W9 E3 Teapot`` on the bunny stand-in (the plane lit where ``lit``),
    from the registry function ``get_scene`` of either package, at
    ``size`` x ``size`` (the registry's 800x450 where None)."""
    desc = with_standin_mesh(get_scene("W9 E3 Teapot"), "bunny.obj")
    if lit:
        desc = with_lit_plane(desc)
    if size is not None:
        desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=size,
                                                                 height=size))
    return desc


def path_stats(accum) -> dict:
    a = np.asarray(accum, np.float64)
    return dict(sum=float(a.sum()), sumsq=float((a * a).sum()), max=float(a.max()))


def path_errors(stats: dict, rtol: float = PATH_RTOL, ref: dict = PATH_REF) -> list:
    """The statistics of ``stats`` that miss ``ref`` by more than ``rtol``
    relative."""
    return [f"{k}: {stats[k]!r} vs {v!r}" for k, v in ref.items()
            if abs(stats[k] - v) > rtol * abs(v)]


def grad_stats(arrays: dict) -> dict:
    """(sum, sum |x|, sum x^2) in float64 per leaf of ``grads_to_arrays``."""
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a, np.float64)
        out[k] = (float(a.sum()), float(np.abs(a).sum()), float((a * a).sum()))
    return out


def bunny_grad_errors(stats: dict, rtol: float = BUNNY_GRAD_RTOL, ref: dict = BUNNY_GRAD_REF,
                      zero: tuple = BUNNY_GRAD_ZERO) -> list:
    """The statistics of ``stats`` that miss ``ref`` (``BUNNY_GRAD_REF``) by
    more than ``rtol`` of their scale, and nonzero leaves that must be
    zero."""
    bad = []
    for k, (s, a, q) in ref.items():
        gs, ga, gq = stats[k]
        if abs(gs - s) > rtol * a or abs(ga - a) > rtol * a or abs(gq - q) > rtol * q:
            bad.append(f"{k}: ({gs!r}, {ga!r}, {gq!r}) vs ({s!r}, {a!r}, {q!r})")
    bad += [f"{k} is not zero" for k in zero if stats[k][1] != 0.0]
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
    a short kernel. A trace that holds no device event at all is taken
    again, up to three times: once on the card the trace of the brute-force
    any-hit query came back without the kernel it ran. Raises unless a
    kernel whose name holds ``key`` ran."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    if not any(key in e.name for e in dev):
        names = sorted({e.name for e in dev})[:5]
        raise AssertionError(f"the profiler saw no kernel named like {key!r} "
                             f"({len(dev)} device events, e.g. {names})")
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
    qblocks, qbox, qnorm = treelet.assemble_blocks(t(verts), t(idx), t(pids), t(valid))
    tb = treelet.TreeletBvh(qblocks=qblocks, qbox=qbox, qnorm=qnorm,
                            t_lo=t(np.zeros((NT, 3), np.float32)),
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


def super_lanes(device, any_hit: bool, seed: int):
    """B1's inputs for the live-lane rule and the stream's edges, from numpy
    with a seed: the synthetic treelets with prim 0 a large triangle on
    z = 0 (12 quarter blocks of 256), and 3 super-tiles of 2048 rays with 10
    emission slots each. Returns the tuple of ``synthetic``.

    Super-tile 0 (en = 13, above KD; entry distances 0): sub-tiles 0-3 have
    1, 31, 33 and 127 live lanes, their other lanes an empty window (tmin 5,
    best t 2) or, in any-hit mode, half of them occluded instead; sub-tile 4
    has 16 dead lanes at +inf (tmin and best t) and 16 live ones with a +inf
    bound, which the "no hit" update lowers to 3e38; in sub-tile 5, 64
    lanes start at z = 3 along -z with tmin 3, and slot 5 emits the big
    triangle's quarter, which they hit at exactly t = 3, so closest lanes
    die there (bt reaches tmin) and any-hit lanes die at their first hit;
    sub-tiles 6-14 are all live; sub-tile 15 is dead at -3e38 (occluded in
    any-hit mode), so its gate bits never test. The gate words set 1, 2,
    16, 15, 0, 2, 4, 4, 16 and 1 bits; the last names only sub-tile 15, so
    the stream reaches it but no sub-tile tests it.
    Super-tile 1 (en = 7): the repair pass's shape, every lane dead at
    -3e38 but 3 in sub-tile 2 and 1 in sub-tile 9; unordered entry
    distances whose slot 3 (9.0) lies beyond every bound, so the stream
    stops there although slots 4-6 lie near.
    Super-tile 2: en = 0.
    In closest mode the twin counts 12 staged slots, 11 rounds, 63 visits
    and 5,485 live lanes over them (x 256 tests); see
    ``tests/test_torch_super_hits.py``."""
    from tracer_torch.kernels.super_hits import SUB, SUPER

    rs = np.random.RandomState(seed)
    n_super, KD = 3, 10
    n = n_super * SUPER
    tb, o, d, tmin, best_t = _synthetic_scene(rs, device, n, plane=True)
    best_pid = np.full(n, -1.0, np.float32)
    for s, n_live in enumerate((1, 31, 33, 127)):
        dead = s * SUB + np.sort(rs.permutation(SUB)[n_live:])
        occluded = dead[1::2] if any_hit else dead[:0]
        empty = np.setdiff1d(dead, occluded)
        tmin[empty], best_t[empty] = 5.0, 2.0
        best_pid[occluded] = 1.0
    at_inf = 4 * SUB + rs.permutation(SUB)[:32]
    tmin[at_inf[:16]] = best_t[at_inf] = np.inf
    axis = slice(5 * SUB, 5 * SUB + 64)
    o[axis, :2] = rs.uniform(-1.0, 1.0, (64, 2)).astype(np.float32)
    o[axis, 2], d[axis], tmin[axis], best_t[axis] = 3.0, [0.0, 0.0, -1.0], 3.0, 4.0
    if any_hit:
        best_pid[15 * SUB:SUPER] = 1.0
        best_pid[2 * SUPER:][rs.rand(SUPER) < 0.1] = 1.0
    else:
        best_t[15 * SUB:SUPER] = -3.0e38
    best_t[SUPER:2 * SUPER] = -3.0e38
    keep = SUPER + np.concatenate([2 * SUB + rs.permutation(SUB)[:3],
                                   9 * SUB + rs.permutation(SUB)[:1]])
    best_t[keep] = rs.uniform(2.5, 4.0, 4).astype(np.float32)
    q = tb.qblocks.cpu().numpy()
    holder = int(np.nonzero(((q[:, 9] == 0) & (q[:, 10] > 0.5)).any(axis=1))[0][0])
    others = [b for b in range(q.shape[0]) if b != holder]
    eids = np.stack([rs.choice(others, KD) for _ in range(n_super)]).astype(np.int32)
    eids[0, 5] = holder
    gm = np.zeros((n_super, KD), np.int32)
    gm[0] = [0x0001, 0x0022, 0xFFFF, 0x7FFF, 0x0000, 0x0030, 0x8421, 0x000F, 0xFFFF, 0x8000]
    gm[1] = 0xFFFF
    gm[2] = rs.randint(1, 1 << 16, KD)
    enear = np.zeros((n_super, KD), np.float32)
    enear[1, :7] = [0.3, 1.0, 0.2, 9.0, 0.1, 0.1, 0.1]
    en = np.array([KD + 3, 7, 0], np.int32)
    t = lambda x: torch.as_tensor(x, device=device)
    sh = lambda x: t(x.reshape(n_super, SUPER, *x.shape[1:]))
    return (tb, t(eids), t(enear), t(en), t(gm), sh(o), sh(d), sh(tmin),
            sh(best_t), sh(best_pid))


def narrow_quarters(tb, tq: int):
    """``tb`` with each quarter block cut into blocks of ``tq`` columns (the
    same triangles in TQ / tq times as many blocks), to hold B1 against its
    twin at a small TQ on the same emission arrays."""
    q = tb.qblocks
    n, rows, TQ = q.shape
    small = q.reshape(n, rows, TQ // tq, tq).permute(0, 2, 1, 3)
    return dataclasses.replace(tb, qblocks=small.reshape(-1, rows, tq).contiguous())


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


# The flat engine's occlusion query on a bumpy blob (kernel against twin
# route on the card; twin route against the JAX package on the CPU): name ->
# (blob subdivisions, treelet size T, rays, seed, K, round cap, share of
# lanes blocked before the query). T = 32, 256 and 1024 give quarters of 8,
# 64 and 256 triangles; K = 8, 4 and 2 overflow (the id-order sweep), the
# caps 2 and 1 cut it short (converged cleared), K = 96 does not overflow.
# The grazing rays test the kernel's sweep gate where rounding decides.
OCCLUSION_CASES = {
    "frame K=96": (24, 32, "frame", 0, 96, 4096, 0.0),
    "frame K=8": (24, 32, "frame", 0, 8, 4096, 0.0),
    "mixed K=8": (24, 32, "mixed", 1, 8, 4096, 0.0),
    "shadow K=4 TQ=64": (24, 256, "shadow", 2, 4, 4096, 0.0),
    "mixed K=2 cap 2": (24, 32, "mixed", 3, 2, 2, 0.0),
    "mixed K=2 cap 1": (24, 32, "mixed", 3, 2, 1, 0.0),
    "mixed K=8 pre-blocked": (24, 32, "mixed", 4, 8, 4096, 0.3),
    "shadow K=2 TQ=256": (64, 1024, "shadow", 5, 2, 4096, 0.0),
    "graze K=2": (24, 32, "graze", 6, 2, 4096, 0.0),
    "graze K=2 TQ=64": (24, 256, "graze", 7, 2, 4096, 0.0),
    "graze K=4 TQ=256": (64, 1024, "graze", 8, 4, 4096, 0.0),
    "coplanar 2^-16 K=2": (24, 32, "coplanar 16", 9, 2, 4096, 0.0),
    "coplanar 2^-20 K=2": (24, 32, "coplanar 20", 10, 2, 4096, 0.0),
    "coplanar 2^-24 K=2": (24, 32, "coplanar 24", 11, 2, 4096, 0.0),
    "coplanar 2^-20 K=2 TQ=256": (64, 1024, "coplanar 20", 12, 2, 4096, 0.0),
}
OCCLUSION_FRAME = (41, 29)


def occlusion_rays(kind: str, seed: int, mesh, T: int = 32):
    """(o, d, tmin, tmax, frame) as numpy from a seed. ``frame``: a 41x29
    pinhole frame from (0.1, 0, 3) towards the blob, windows to 2.5;
    ``mixed``: 1024 rays, half from one point around (3, 0.2, 0.1) into the
    blob, half from anywhere in any direction, windows to 4, one in ten
    dead (tmax 0); ``shadow``: 4096 parallel rays towards a directional
    light from random points on the mesh (lifted 1e-3 along the light),
    windows [1e-4, 3e38); ``graze``: 64 sub-tiles of 128 rays, each
    aimed at one vertex of the mesh, which is often the corner that makes a
    quarter box's face: a third parallel to an axis plane through the
    vertex (that coordinate of d exactly 0, of o 0, 1 or 2 ulps off the
    vertex's on either side), a third from afar at the vertex or an ulp
    beside it, a third from origins on the vertex's axis plane, windows
    [1e-5, 4); ``coplanar c`` (c = 16, 20 or 24): 64 sub-tiles of 128
    rays, each sub-tile from one origin 2.5 away, almost in the plane of
    one triangle whose vertex lies on a face of its quarter's box (treelets
    of ``T``), at cos 2^-c to the plane's normal and aimed past that vertex,
    outside the box, by 0.5-64 times 8 * 2^-16 along the plane, windows
    [1e-5, 4): where a Möller test in float32 accepts such a ray, its t
    and barycentrics are ill-conditioned (the sweep gate's conditioning
    term)."""
    rs = np.random.RandomState(seed)
    if kind == "frame":
        W, H = OCCLUSION_FRAME
        u = (np.arange(W) + 0.5) / W - 0.5
        v = 0.5 - (np.arange(H) + 0.5) / H
        uu, vv = np.meshgrid(u, v)
        d = np.stack([uu.ravel(), vv.ravel(), -np.ones(W * H)], -1)
        o = np.tile(np.array([[0.1, 0.0, 3.0]]), (W * H, 1))
        tmin, tmax, frame = np.full(W * H, 1e-5), np.full(W * H, 2.5), OCCLUSION_FRAME
    elif kind == "mixed":
        n = 1024
        o1 = np.tile(np.array([[3.0, 0.2, 0.1]]), (n // 2, 1))
        d1 = rs.randn(n // 2, 3) * 0.4 - o1
        o2 = rs.randn(n // 2, 3) * 3.0
        o, d = np.concatenate([o1, o2]), np.concatenate([d1, rs.randn(n // 2, 3)])
        tmin, tmax, frame = np.full(n, 1e-5), np.where(rs.rand(n) < 0.1, 0.0, 4.0), None
    elif kind == "graze":
        o, d = [], []
        for g in range(64):
            v = mesh.vertices[rs.randint(mesh.vertices.shape[0])].astype(np.float32)
            k, sub = rs.randint(3), g % 3
            if sub == 0:  # parallel to the plane x_k = v_k, at most 2 ulps off it
                u = rs.randn(128, 3)
                u[:, k] = 0.0
                u /= np.linalg.norm(u, axis=1, keepdims=True)
                og = (v - 2.5 * u).astype(np.float32)
                og[:, k] = v[k]
                steps = rs.randint(-2, 3, 128)
                for _ in range(2):
                    m = steps != 0
                    og[m, k] = np.nextafter(og[m, k], np.float32(np.inf) * np.sign(steps[m]))
                    steps -= np.sign(steps)
                dg = u
            else:  # from afar at the vertex (an ulp beside it), or from its axis plane
                aim = np.repeat(v[None], 128, axis=0)
                j = rs.randint(3, size=128)
                aim[np.arange(128), j] = np.nextafter(
                    aim[np.arange(128), j], np.where(rs.rand(128) < 0.5, -np.inf, np.inf)
                    .astype(np.float32))
                aim[rs.rand(128) < 0.5] = v
                if sub == 1:
                    dg = rs.randn(1, 3) + 0.05 * rs.randn(128, 3)
                    og = aim - 2.5 * dg / np.linalg.norm(dg, axis=1, keepdims=True)
                else:
                    og = v + 0.05 * rs.randn(128, 3)
                    og[:, k] = v[k]
                    dg = aim - og
            o.append(og)
            d.append(dg)
        o, d = np.concatenate(o).astype(np.float64), np.concatenate(d)
        n = o.shape[0]
        tmin, tmax, frame = np.full(n, 1e-5), np.full(n, 4.0), None
    elif kind.startswith("coplanar"):
        o, d = coplanar_rays(rs, mesh, T, 2.0 ** -int(kind.split()[1]))
        n = o.shape[0]
        tmin, tmax, frame = np.full(n, 1e-5), np.full(n, 4.0), None
    else:
        n = 4096
        tri = mesh.vertices[mesh.indices[rs.randint(0, mesh.indices.shape[0], n)]]
        w = rs.dirichlet(np.ones(3), n)
        light = np.array([0.4, 0.8, -0.45]) / np.linalg.norm([0.4, 0.8, -0.45])
        o = (tri * w[:, :, None]).sum(axis=1) + 1e-3 * light
        d = np.tile(light, (n, 1))
        tmin, tmax, frame = np.full(n, 1e-4), np.full(n, 3.0e38), None
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    f = np.float32
    return o.astype(f), d.astype(f), tmin.astype(f), tmax.astype(f), frame


def coplanar_rays(rs, mesh, T: int, cos: float, n_sub: int = 64):
    """The ``coplanar`` rays of ``occlusion_rays``: (o, d) float64, n_sub
    sub-tiles of 128. Quarters are those of the port's treelet cut of
    ``mesh`` with ``T`` triangles a treelet (the JAX package cuts the
    same)."""
    from tracer_torch.accel import lbvh, treelet

    host = treelet.build_host(lbvh.build(*mesh.bboxes(), max_prims=4), T=T)
    tq = T // treelet.NQ
    V = mesh.vertices.astype(np.float64)
    o, d = [], []
    while len(o) < n_sub:
        b, j = rs.randint(host.pids.shape[0]), rs.randint(treelet.NQ)
        slots = np.arange(j * tq, (j + 1) * tq)
        slots = slots[slots < host.counts[b]]
        if slots.size == 0:
            continue
        tri = mesh.indices[host.pids[b, slots]]  # (m, 3) vertex ids
        pts = V[tri]  # (m, 3, 3)
        k, side = rs.randint(3), rs.randint(2)
        face = pts[..., k].max() if side else pts[..., k].min()
        at = np.argwhere(pts[..., k] == face)
        i, c = at[rs.randint(at.shape[0])]
        v = pts[i, c]
        nrm = np.cross(pts[i, 1] - pts[i, 0], pts[i, 2] - pts[i, 0])
        nrm /= np.linalg.norm(nrm)
        out = np.eye(3)[k] * (1.0 if side else -1.0)
        p = out - (out @ nrm) * nrm  # the outward axis, projected into the plane
        if np.linalg.norm(p) < 0.3:
            continue
        p /= np.linalg.norm(p)
        w = np.cross(nrm, p) * rs.choice([-1.0, 1.0])  # in the plane, along the face
        d0 = np.sqrt(1.0 - cos * cos) * w + cos * rs.choice([-1.0, 1.0]) * nrm
        og = v - 2.5 * d0
        aim = v + (8.0 * 2.0 ** -16 * 2.0 ** rs.uniform(-1.0, 6.0, 128))[:, None] * p
        o.append(np.repeat(og[None], 128, axis=0))
        d.append(aim - og)
    return np.concatenate(o), np.concatenate(d)


def occlusion_case(name: str, device):
    """(tb, em, max_rounds) for ``OCCLUSION_CASES[name]`` on ``device``:
    the port's treelets of the blob and ``flat.emissions(..., any_hit=True)``
    of its rays, with the share of lanes the case names already blocked
    (flag 1.0, from the same seed)."""
    from tracer_torch.accel import flat, lbvh, treelet
    from tracer_torch.geometry.procedural import bumpy_blob
    from tracer_torch.kernels.intersect import make_rays

    n_sub, T, kind, seed, K, max_rounds, pre = OCCLUSION_CASES[name]
    mesh = bumpy_blob(n_sub, n_sub, 1.0, (0.0, 0.0, 0.0))
    host = treelet.build_host(lbvh.build(*mesh.bboxes(), max_prims=4), T=T)
    tb = treelet.from_host(host, torch.as_tensor(mesh.vertices, device=device),
                           torch.as_tensor(mesh.indices.astype(np.int32), device=device))
    o, d, tmin, tmax, frame = occlusion_rays(kind, seed, mesh, T)
    t = lambda x: torch.as_tensor(x, device=device)
    em = flat.emissions(make_rays(t(o), t(d), t(tmin), t(tmax)), tb, frame,
                        any_hit=True, K=K)
    if pre:
        blocked = np.random.RandomState(seed).rand(*em.bp0.shape) < pre
        em = dataclasses.replace(em, bp0=t(np.where(blocked, 1.0, -1.0).astype(np.float32)))
    return tb, em, max_rounds


def brute_case(kind: str, seed: int, n: int = 4096):
    """Inputs of the brute-force engine from numpy with a seed: (vertices,
    indices, o, d, tmin, tmax, edge). ``kind`` "cornell": the Cornell box fixture,
    with rays from the camera's eye into the box and from points inside it
    in all directions; "seeded64": 64 random triangles about the origin,
    with rays from a sphere of radius 4 toward them. Either way a tenth of
    the rays aim at a point on a triangle's edge (shared edges and quad
    diagonals, where two triangles tie; ``edge`` marks them), a fifth have
    a finite tmax (shadow rays), and a twentieth an empty window (tmin ==
    tmax, as the path loop gives done lanes)."""
    from tracer_torch.geometry.obj import load_obj

    rs = np.random.RandomState(seed)
    if kind == "cornell":
        mesh = load_obj(str(FIXTURES / "CornellBox.obj"))
        verts, idx = mesh.vertices, mesh.indices.astype(np.int32)
        lo, hi = np.float32([0, 0, 0]), np.float32([556, 548.8, 559.2])
        o = np.where(rs.rand(n, 1) < 0.5, np.float32([277, 275, -570]),
                     lo + rs.uniform(0.05, 0.95, (n, 3)) * (hi - lo))
        tgt = lo + rs.uniform(0.0, 1.0, (n, 3)) * (hi - lo)
        tmin0 = 1e-2
    elif kind == "seeded64":
        c = rs.uniform(-1.0, 1.0, (64, 1, 3))
        verts = (c + rs.normal(0.0, 0.3, (64, 3, 3))).reshape(-1, 3)
        idx = np.arange(192, dtype=np.int32).reshape(64, 3)
        o = rs.normal(0.0, 1.0, (n, 3))
        o *= 4.0 / np.linalg.norm(o, axis=1, keepdims=True)
        tgt = rs.uniform(-1.0, 1.0, (n, 3))
        tmin0 = 1e-5
    else:
        raise ValueError(kind)
    verts = np.asarray(verts, np.float32)
    edge = rs.rand(n) < 0.1
    tri = idx[rs.randint(0, idx.shape[0], n)]
    k = rs.randint(0, 3, n)
    a, b = verts[tri[np.arange(n), k]], verts[tri[np.arange(n), (k + 1) % 3]]
    tgt = np.where(edge[:, None], a + rs.rand(n, 1) * (b - a), tgt)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, tmin0)
    tmax = np.where(rs.rand(n) < 0.2, rs.uniform(0.0, 1.2, n) * np.linalg.norm(tgt - o, axis=1),
                    5000.0)
    tmax = np.where(rs.rand(n) < 0.05, tmin, tmax)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return verts, idx, f32(o), f32(d), f32(tmin), f32(tmax), edge


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


def texel_stream(seed: int, lanes: int = 262_144, shape=(32, 64), crowd: float = 0.9):
    """An unsorted (ids (4 * lanes,) int32 flat texel ids, rows (4 * lanes,
    4) float32 cotangents, H * W) stream of one bilinear environment lookup
    from numpy with a seed, skewed as the camera rays of a path's first
    bounce are: a ``crowd`` share of the lanes look into a 0.1 x 0.2 window
    of (u, v) (a few dozen texels of the 32x64 map), the rest anywhere. The
    ids are the four taps of ``texture.sample_bilinear`` (repeat wrapping),
    tap-major, as ``texture._texels`` stacks them. 262,144 lanes is one
    512x512 lookup: 1,048,576 rows onto 2,048 texels."""
    rs = np.random.RandomState(seed)
    h, w = shape
    near = rs.rand(lanes) < crowd
    u = np.where(near, rs.uniform(0.45, 0.55, lanes), rs.uniform(0.0, 1.0, lanes))
    v = np.where(near, rs.uniform(0.4, 0.6, lanes), rs.uniform(0.0, 1.0, lanes))
    x0 = np.floor(u * w - 0.5).astype(np.int64) % w
    y0 = np.floor(v * h - 0.5).astype(np.int64) % h
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    ids = np.concatenate([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1])
    rows = (rs.standard_normal((ids.shape[0], 4))
            * rs.choice([1e-3, 1.0, 30.0], (ids.shape[0], 1))).astype(np.float32)
    return ids.astype(np.int32), rows, h * w


def check_texel_place(name, sids, rows, n) -> int:
    """The texel placement's kernel against its twin on the card, for a
    sorted stream: two launches bitwise equal, and bitwise the twin run on
    a CPU copy (the same fixed chunk order). Returns the longest segment."""
    from tracer_torch.kernels import texel_place

    k1 = texel_place.place(sids, rows, n)
    k2 = texel_place.place(sids, rows, n)
    torch.cuda.synchronize()
    bits = lambda x: x.cpu().view(torch.int32)
    if not torch.equal(bits(k1), bits(k2)):
        raise AssertionError(f"texel_place {name}: two launches differ")
    cpu = texel_place.place_reference(sids.cpu(), rows.cpu(), n)
    if not torch.equal(bits(k1), cpu.view(torch.int32)):
        bad = int((bits(k1) != cpu.view(torch.int32)).sum())
        raise AssertionError(f"texel_place {name}: {bad} sums differ from the CPU twin")
    longest = int(torch.bincount(sids.long(), minlength=n).max()) if sids.numel() else 0
    log(f"  texel_place {name}: M={sids.shape[0]} texels={n}, longest segment {longest}; "
        "launches equal bitwise, = CPU twin bitwise")
    return longest


def texel_times(dev, card: str) -> dict:
    """The texel placement at the main path's shape (one 512x512 W9 E1
    lookup: ``texel_stream``'s 1,048,576 rows onto 2,048 texels), checked
    against its twin, then timed: the kernel (CUDA events, and device time
    by the profiler), its byte bound (an int32 id and four float32 a row
    read, four float32 a texel written), the twin, the whole backward it
    serves (the stable sort, the permutation of the rows, the kernel), and
    PyTorch's index backward, ``index_put_(accumulate=True)`` of the
    unsorted stream (``library_ms``)."""
    from tracer_torch.kernels import texel_place

    ids, rows, n = texel_stream(0)
    ids_d, rows_d = torch.as_tensor(ids, device=dev), torch.as_tensor(rows, device=dev)
    sids, perm = torch.sort(ids_d, stable=True)
    srows = rows_d[perm].contiguous()
    longest = check_texel_place("W9 E1 512x512 first-bounce lookup (synthetic)", sids, srows, n)
    kern = lambda: texel_place.place(sids, srows, n)
    twin = lambda: texel_place.place_reference(sids, srows, n)

    cols = torch.arange(4, device=dev)

    def whole():  # as texture._GatherTexels.backward
        s, p = torch.sort(ids_d, stable=True)
        return texel_place.place(s, rows_d[p[:, None], cols], n)

    ids_l = ids_d.long()
    lib = lambda: torch.zeros((n, 4), dtype=torch.float32, device=dev).index_put_(
        (ids_l,), rows_d, accumulate=True)
    for fn in (kern, twin, whole, lib):
        fn()
    out = dict(rows=int(ids.shape[0]), texels=n, longest=longest)
    out["ms"] = cuda_events_ms(kern, 100)
    out["device_ms"] = profiled_device_ms(kern, 100, "texel_place_")
    out["plain_ms"] = cuda_events_ms(twin, 20)
    out["backward_ms"] = cuda_events_ms(whole, 50)
    out["library_ms"] = cuda_events_ms(lib, 10)
    out["bound_ms"], out["bound_by"] = bound_ms(ids.shape[0] * (4 + 16) + n * 16,
                                                ids.shape[0] * 4)
    log(f"[time] texel_place W9 E1 512x512 lookup (M={out['rows']}, texels={n}, longest "
        f"segment {longest}): kernel {out['ms']:.4f} ms per call (CUDA events; device time "
        f"{out['device_ms']:.4f} ms by the profiler), twin {out['plain_ms']:.4f} ms, sort + "
        f"permute + kernel {out['backward_ms']:.4f} ms, index_put_(accumulate=True) "
        f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}); {card}")
    if out["ms"] > out["library_ms"]:
        raise AssertionError("texel_place is slower than index_put_(accumulate=True)")
    return out


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


def b1_bound(args, tests: int) -> tuple[float, str]:
    """B1 on one set of emissions: every input read once (the quarter
    blocks that some live slot with a gate bit names), the output written
    once, and ``tests`` Möller tests: 128 x TQ per (sub-tile, quarter) visit
    of the twin (the bound over all lanes), or its ``live_tests`` (the
    bound over the work the function needs)."""
    tb, ids, enear, en, gm, o, d, tmin, bt, bp = args
    TQ = tb.qblocks.shape[2]
    live = (torch.arange(ids.shape[1], device=ids.device) < en[:, None]) & (gm != 0)
    blocks = ids.clamp(0, tb.qblocks.shape[0] - 1)[live].unique().numel() * 16 * TQ * 4
    n_bytes = blocks + nbytes(ids, enear, en, gm, o, d, tmin, bt, bp) + nbytes(bt, bp)
    return bound_ms(n_bytes, tests * OPS_PER_TEST)


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


# Float32 operations of one ray's slab test against one child box in packet
# phase A's walk: 6 differences, 6 products, 3 minima and 3 maxima, the 2 + 2
# folds over the axes and 3 comparisons.
OPS_PER_SLAB = 25
WALK_FIELDS = ("cur", "level", "asc", "done", "paused", "snear", "sref")


def walk_buffers(wk) -> list:
    """What phase A's walk iterations write in the buffers ``wk`` (a
    ``packet._Walk``): the state in ``WALK_FIELDS``' order, then eids,
    enear and en."""
    return [*(getattr(wk.st, f) for f in WALK_FIELDS), wk.eids, wk.enear, wk.en]


def walk_twin(wk):
    """The walk buffers ``wk`` with a state and emissions of their own (the
    inputs shared), for ``packet._body`` beside the walk kernel."""
    from tracer_torch.accel import packet

    twin = copy.copy(wk)
    twin.st = packet.TravState(**{f: getattr(wk.st, f).clone() for f in WALK_FIELDS})
    twin.eids, twin.enear, twin.en = wk.eids.clone(), wk.enear.clone(), wk.en.clone()
    return twin


def restore_walk(wk, saved) -> None:
    for x, y in zip(walk_buffers(wk), walk_buffers(saved)):
        x.copy_(y)


def first_bounce_walk(scene, cfg):
    """Packet phase A's walk buffers of ``scene``'s tree (the cached ones)
    loaded as ``packet._phase_a_chunk`` loads them for the
    first round of a closest-hit query of the frame's path-mode camera rays
    in 8x16 packets; and a copy of the loaded state to start again from."""
    from tracer_torch.accel import packet
    from tracer_torch.render import integrator

    rays, _ = integrator._path_primary(scene, cfg)
    tile = lambda x, fill: packet.to_tiles(x, cfg.width, cfg.height, fill)
    o, d, tmin, tmax = (tile(rays.o, 1.0e30), tile(rays.d, 1.0), tile(rays.tmin, 1.0),
                        tile(rays.tmax, 0.0))
    C, D = o.shape[0], max(scene.tb.depth, 1)
    if C > packet.CHUNK_TILES:
        raise AssertionError(f"the first-bounce wavefront is {C} tiles, over one chunk")
    wk = packet._walk(scene.tb, C, D, packet.K_EMIT, o.device)
    wk.load(packet._init_state(C, D, o.device), o, d, tmin, tmax)
    return wk, walk_twin(wk)


def check_walk_kernel(wk, saved) -> tuple[int, dict]:
    """From ``saved``, launches of the walk kernel for ``CHECK_EVERY``
    iterations against as many ``packet._body`` calls on a copy of the
    buffers, until every tile is done or paused: every buffer bit for bit
    after each launch. Returns the launches and, over the first launch's
    iterations, what ``walk_bound`` counts: ``visits`` of tiles (active,
    not ascending), the distinct top-tree rows they visit (``top_rows``),
    the distinct (tile, level) rows of the sibling stacks that active
    tiles read or write (``stack_rows``), and the emissions written
    (``emitted``)."""
    from tracer_torch.accel import packet
    from tracer_torch.kernels import phase_a_walk

    names = [*WALK_FIELDS, "eids", "enear", "en"]
    restore_walk(wk, saved)
    launches, first = 0, {}
    while bool((~wk.st.done & ~wk.st.paused).any()):
        twin = walk_twin(wk)
        top_rows, stack_rows, visits = set(), set(), 0
        for _ in range(packet.CHECK_EVERY):
            st = twin.st
            active = ~st.done & ~st.paused
            visit = active & ~st.asc
            visits += int(visit.sum())
            top_rows.update(st.cur[visit].tolist())
            tiles = active.nonzero()[:, 0]
            stack_rows.update(zip(tiles.tolist(),
                                  st.level[tiles].clamp(0, wk.D - 1).tolist()))
            packet._body(twin)
        if not launches:
            emitted = int((twin.en.clamp(max=wk.K) - wk.en.clamp(max=wk.K)).sum())
            first = dict(visits=visits, top_rows=len(top_rows), stack_rows=len(stack_rows),
                         emitted=emitted)
        phase_a_walk.walk(wk, packet.CHECK_EVERY)
        for name, a, b in zip(names, walk_buffers(wk), walk_buffers(twin)):
            bits = (lambda x: x.view(torch.int32)) if a.dtype == torch.float32 else (lambda x: x)
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"walk kernel launch {launches}: {name} differs from "
                                     f"_body's in {int((bits(a) != bits(b)).sum())} places")
        launches += 1
    return launches, first


def time_walk(wk, saved, reps: int = 50) -> tuple[float, float]:
    """Device ms of one batch of ``CHECK_EVERY`` walk iterations from
    ``saved``: the kernel launched as phase A launches it, and ``_body``
    run eagerly. Each batch starts from a
    restored state behind a ``torch.cuda._sleep``, so its events time the
    device alone where the host enqueues faster than the card runs."""
    from tracer_torch.accel import packet
    from tracer_torch.kernels import phase_a_walk

    def timed(fn, n):
        spans = []
        for _ in range(n):
            restore_walk(wk, saved)
            torch.cuda._sleep(1_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans) / n

    def body():
        for _ in range(packet.CHECK_EVERY):
            packet._body(wk)

    kernel = timed(lambda: phase_a_walk.walk(wk, packet.CHECK_EVERY), reps)
    return kernel, timed(body, 5)


def walk_bound(wk, work: dict) -> tuple[float, str]:
    """The walk kernel on one chunk, over ``work`` (``check_walk_kernel``'s
    count of one launch): o, 1/d, tmin and prune of each ray and the
    tiles' loosest bounds read once, the tiles' state read and written
    once, each top-tree row visited (8 boxes and 8 refs) and each
    sibling-stack row touched (8 nears and 8 refs) moved once, each
    emission (an id and a near) written once; ``OPS_PER_SLAB`` x 8
    children x 128 rays per visit (a tile that visits a node in an
    iteration)."""
    st = wk.st
    n_bytes = (nbytes(wk.o, wk.inv_d, wk.tmin, wk.prune, wk.amax)
               + 2 * nbytes(st.cur, st.level, st.asc, st.done, st.paused, wk.en)
               + work["top_rows"] * nbytes(wk.top[0], wk.top_ref[0])
               + work["stack_rows"] * nbytes(st.snear[0, 0], st.sref[0, 0])
               + work["emitted"] * (wk.eids.element_size() + wk.enear.element_size()))
    return bound_ms(n_bytes, OPS_PER_SLAB * 8 * 128 * work["visits"])


def occlusion_bound(tb, em, max_rounds: int, tests: int) -> tuple[float, str]:
    """The any-hit query on one wavefront's emissions: every input read
    once (the quarter blocks and boxes that a gated list slot names and,
    where a super-tile overflows, the swept ones; the rays, windows, flags,
    sub-tile bounds and the list), the flags written once, and ``tests``
    Möller tests (the twin route's ``live_tests``, or the kernel's own)."""
    from tracer_torch.kernels import super_occluded

    ntq, _, tq = tb.qblocks.shape
    kd = em.ids.shape[1]
    named = em.ids.clamp(0, ntq - 1)[
        (torch.arange(kd, device=em.ids.device) < em.en[:, None]) & (em.gm != 0)]
    if bool(em.overflow.any()):
        swept = super_occluded.sweep_length(ntq, kd, max_rounds)
        named = torch.cat([named, torch.arange(swept, dtype=named.dtype, device=named.device)])
    n_bytes = (named.unique().numel() * (16 * tq + 6) * 4
               + nbytes(em.ids, em.enear, em.en, em.gm, em.o, em.d, em.tmin, em.bt0, em.bp0,
                        em.sb, em.prune_sub) + nbytes(em.bp0))
    return bound_ms(n_bytes, tests * OPS_PER_TEST)


@contextlib.contextmanager
def caught_queries():
    """While active, ``super_occluded.occluded`` keeps each call's
    arguments and result in the yielded list (one append on the host per
    call), so that the queries of timed runs are checked after them."""
    from tracer_torch.kernels import super_occluded

    calls = []
    occluded = super_occluded.occluded

    def catch(tb, em, max_rounds, **kw):
        out = occluded(tb, em, max_rounds, **kw)
        calls.append((tb, em, max_rounds, out))
        return out

    super_occluded.occluded = catch
    try:
        yield calls
    finally:
        super_occluded.occluded = occluded


def occlusion_mismatch(em, got, want) -> int:
    """Lanes of the wavefront (its padding left out) on which two results
    of the any-hit query differ: t row, blocked flag or converged flag, bit
    for bit."""
    from tracer_torch.kernels.super_hits import SUPER

    (kt, kp, kc), (rt, rp, rc) = got, want
    bits = lambda x: x.contiguous().view(torch.int32)
    bad = (bits(kt) != bits(rt)) | (bits(kp) != bits(rp)) | (kc != rc)[:, None].expand(-1, SUPER)
    return int(em.untile(bad).sum())


def check_sweep_gates(name: str, tb, em, max_rounds: int) -> tuple[int, int]:
    """The kernel's sweep gates (``kernel_sweep_gates``: the query's own
    gate code over every (sub-tile, quarter) pair) against ``sweep_gates``
    (the plain version, on the same device), bit for bit; raises on any
    pair that differs.
    Returns ``open_share``: the swept pairs left open, and all of them."""
    from tracer_torch.kernels import super_occluded

    got = super_occluded.kernel_sweep_gates(tb, em)
    bad = int((got != super_occluded.sweep_gates(tb, em)).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} (sub-tile, quarter) gates differ from sweep_gates")
    n_open, n_pairs = super_occluded.open_share(tb, em, got, max_rounds)
    log(f"  {name}: {got.numel()} (sub-tile, quarter) gates equal sweep_gates' bit for bit; "
        f"the sweep's pairs left open: {n_open} of {n_pairs}"
        + (f" ({n_open / n_pairs:.4%})" if n_pairs else ""))
    return n_open, n_pairs


def check_queries(name: str, calls, hits) -> None:
    """Each caught any-hit query against the twin route run with ``hits``
    on the same emissions; raises on any lane that differs."""
    from tracer_torch.kernels import super_occluded

    lanes = 0
    for tb, em, max_rounds, got in calls:
        bad = occlusion_mismatch(em, got, super_occluded.occluded_reference(
            tb, em, max_rounds, hits=hits))
        if bad:
            raise AssertionError(f"{name}: {bad} lanes of a query differ from the twin route")
        lanes += em.untile(got[1]).numel()
    if not calls:
        raise AssertionError(f"{name}: no any-hit query was caught")
    log(f"  {name}: {len(calls)} queries, {lanes} lanes, flags and converged equal to the twin "
        f"route's on {hits.__name__} bit for bit")


# Hand-written Cornell boxes (tests/fixtures) that stand in for the reference's
# models of the same names, which the registry rows name under its asset root.
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
FIXTURE_MODELS = ("CornellBox.obj", "CornellBoxWithBlocks.obj")


def with_fixture_model(desc):
    """``desc`` with its model read from the repository's fixtures, for the
    two Cornell boxes; raises for any other model that is missing."""
    name = os.path.basename(desc.model or "")
    if name in FIXTURE_MODELS:
        return dataclasses.replace(desc, model=str(FIXTURES / name))
    if desc.model is not None and not os.path.exists(desc.model):
        raise FileNotFoundError(f"{desc.name}: model {desc.model} is missing and has no fixture")
    return desc


def with_seeded_env(scene, desc, device):
    from tracer_torch.render import texture

    kind = texture.ENV_RGBE if desc.hdri_rgbe else texture.ENV_LDR
    env = torch.as_tensor(seeded_env(desc.hdri_rgbe), device=device)
    return dataclasses.replace(scene, env=texture.TextureBuf(data=env, kind=kind))


def _oracle_row(name, w=24, h=24, sel=None, standin=None, fixture=False, textured=False,
                **cfg_kw):
    """A descriptor maker for ``ORACLE_CASES``: the registry row at w x h,
    with selections, a stand-in mesh, the Cornell fixture or the plane
    marked textured where asked."""
    def make():
        from tracer_torch.scenes.registry import get_scene

        d = get_scene(name)
        if standin:
            d = with_standin_mesh(d, standin)
        if fixture:
            d = with_fixture_model(d)
        if textured:
            d = with_textured_plane(d)
        if sel:
            d = dataclasses.replace(d, selection1=sel[0], selection2=sel[1])
        return dataclasses.replace(d, cfg=dataclasses.replace(d.cfg, width=w, height=h,
                                                              **cfg_kw))
    return make


# The port's renderer against the port's CPU oracle (phase 17 and
# ``tests/test_torch_oracle.py``): the rows of ``tests/test_oracle_parity.py``
# whose assets exist, at its sizes and thresholds. name: (descriptor maker,
# iteration, plane-texture mode (None: no texture; else ``seeded_texture``),
# seeded environment, atol, share of pixels that must match).
ORACLE_CASES = {
    "W1 E6": (_oracle_row("W1 E6"), 0, None, False, 2e-3, 0.999),
    "W1 E4": (_oracle_row("W1 E4"), 0, None, False, 2e-3, 0.999),
    "W2 mirror": (_oracle_row("W2 E2", sel=(2, 0)), 0, None, False, 2e-3, 0.999),
    "W2 transmit": (_oracle_row("W2 E3", sel=(3, 0)), 0, None, False, 2e-3, 0.999),
    "W2 phong glossy": (_oracle_row("W2 E5", sel=(4, 1)), 0, None, False, 2e-3, 0.999),
    "W5 E2": (_oracle_row("W5 E2 Teapot", 16, 16, standin="bunny.obj", traversal="brute"), 0,
              None, False, 2e-3, 0.999),
    "W5 E5": (_oracle_row("W5 E5 Cornell Box", 16, 16, fixture=True, traversal="brute"), 0,
              None, False, 2e-3, 0.99),
    "W6 E1 mix_ka": (_oracle_row("W6 E1 Bunny", 16, 16), 0, None, False, 2e-3, 0.99),
    **{f"W8 E3 it{it}": (_oracle_row("W8 E3 Absorption", 16, 16, fixture=True,
                                     traversal="brute"), it, None, False, 5e-3, 0.99)
       for it in (0, 1, 3)},
    "W3 E3": (_oracle_row("W3 E3"), 0, None, False, 2e-3, 0.999),
    "W3 E4": (_oracle_row("W3 E4"), 0, None, False, 2e-3, 0.999),
    "W3 E3 textured": (_oracle_row("W3 E3", textured=True), 0, 1, False, 2e-3, 0.999),
    "W3 E4 textured nearest": (_oracle_row("W3 E4", textured=True), 0, 3, False, 2e-3, 0.999),
    "W9 E1": (_oracle_row("W9 E1 Bunny", 16, 16), 0, None, True, 5e-3, 0.99),
    "W9 E2": (_oracle_row("W9 E2 Bunny", 16, 16), 0, None, True, 5e-3, 0.99),
}


def oracle_score(img, ref, atol) -> float:
    """Share of pixels within ``tests/test_oracle_parity.py``'s
    ``assert_close`` (rtol 1e-3, ``atol``) on every channel."""
    return float(np.isclose(img, ref, atol=atol, rtol=1e-3).all(axis=-1).mean())


def oracle_render_both(name: str, device):
    """(the port's frame on ``device``, the port's oracle's), (H, W, 3)
    float32 each, of ``ORACLE_CASES[name]``: the seeded texture (uv scale 2
    under the nearest sampler, as ``tests/test_oracle_parity.py`` runs W3
    E4) and the seeded environment bound in both where the case asks."""
    from tracer_torch.oracle import cpu_tracer as oracle
    from tracer_torch.render import integrator
    from tracer_torch.render import texture as tex
    from tracer_torch.scenes.build import build_oracle_scene, build_scene

    make, it, mode, env, _, _ = ORACLE_CASES[name]
    desc = make()
    scene, cfg = build_scene(desc, device)
    osc, ocfg, cam = build_oracle_scene(desc)
    if mode is not None:
        uv = (2.0, 2.0) if mode == tex.TEX_NEAREST else (1.0, 1.0)
        img = seeded_texture()
        scene = dataclasses.replace(
            scene, texture=tex.TextureBuf(data=torch.as_tensor(img, device=device)),
            uniforms=dataclasses.replace(scene.uniforms, use_texture=mode,
                                         uv_scale=torch.tensor(uv, device=device)))
        osc.texture_img, osc.tex_mode, osc.uv_scale = img, mode, np.array(uv, np.float32)
    if env:
        scene = with_seeded_env(scene, desc, device)
        osc.env_img, osc.env_rgbe = seeded_env(desc.hdri_rgbe), desc.hdri_rgbe
    got = integrator.render_sample(integrator.with_iteration(scene, it), cfg)
    ref = oracle.render(osc, ocfg, cam, iteration=it)
    return got.cpu().numpy().reshape(cfg.height, cfg.width, 3), ref


def instrumented_step(scene, cfg, state) -> dict:
    """One progressive step with spies on the path-mode layers: bounces,
    ray segments (lanes with a non-empty window at each bounce's trace),
    shadow rays (lanes with a non-empty window at each ``trace_occluded``),
    B3 rounds per bounce with their arguments, the CUDA-event span of each
    phase A call and each B3 call, phase A's host time (it ends on a host
    read of its loop condition, so the host clock brackets its device work
    too) against the whole step's, any-hit rounds and truncated lanes. The
    spies read the device, so this frame is not a timed one."""
    from tracer_torch.accel import packet
    from tracer_torch.render import integrator, progressive

    rec = dict(bounces=0, segments=0, rounds=[], bad=0, any_hit_rounds=0, phase_a_host_ms=0.0,
               shadow=0)
    ev_a, ev_b = [], []
    orig = (integrator.trace_closest, packet._phase_a_chunk, packet._dispatch_hits,
            integrator._paint_bad, integrator.trace_occluded)

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

    def occluded(sc, c, rays):
        rec["shadow"] += int((rays.tmax > rays.tmin).sum())
        return orig[4](sc, c, rays)

    integrator.trace_closest, packet._phase_a_chunk = trace, phase_a_host
    packet._dispatch_hits, integrator._paint_bad = dispatch, paint
    integrator.trace_occluded = occluded
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        progressive.step(scene, cfg, state)
        torch.cuda.synchronize()
        rec["frame_host_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        (integrator.trace_closest, packet._phase_a_chunk, packet._dispatch_hits,
         integrator._paint_bad, integrator.trace_occluded) = orig
    rec["phase_a_ms"] = sum(s.elapsed_time(e) for s, e in ev_a)
    rec["b3_ms"] = [s.elapsed_time(e) for s, e in ev_b]
    return rec


def cornell_instrumented(scene, cfg, state) -> dict:
    """One progressive step with spies on the brute-force path's layers:
    bounces, ray segments (lanes with a non-empty window at each bounce's
    trace), shadow rays with a non-empty window, truncated lanes, and the
    brute-force engine's calls, with the arguments of the closest-hit and
    the any-hit call of bounce 2. The spies read the device, so this frame
    is not a timed one. Spans are on for it, so a path bounce on the
    brute-force engine runs eagerly (bit for bit as its CUDA graph, which
    would run past the spies)."""
    from tracer_torch import obs
    from tracer_torch.kernels import intersect
    from tracer_torch.render import integrator, progressive

    rec = dict(bounces=0, segments=0, shadow=0, bad=0, brute_calls=0, brute_args={})
    orig = (integrator.trace_closest, integrator.trace_occluded, integrator._paint_bad,
            intersect.mesh_brute_force, intersect.mesh_brute_force_anyhit)

    def trace(sc, c, rays, *args, **kw):
        rec["bounces"] += 1
        rec["segments"] += int((rays.tmax > rays.tmin).sum())
        return orig[0](sc, c, rays, *args, **kw)

    def occluded(sc, c, rays):
        rec["shadow"] += int((rays.tmax > rays.tmin).sum())
        return orig[1](sc, c, rays)

    def paint(result, bad):
        rec["bad"] += int(bad.sum())
        return orig[2](result, bad)

    def spy(fn, key):
        def run(*args):
            rec["brute_calls"] += 1
            if rec["bounces"] == 2:
                rec["brute_args"][key] = args
            return fn(*args)
        return run

    (integrator.trace_closest, integrator.trace_occluded, integrator._paint_bad,
     intersect.mesh_brute_force, intersect.mesh_brute_force_anyhit) = (
        trace, occluded, paint, spy(orig[3], "closest"), spy(orig[4], "any-hit"))
    spans = obs.SPANS
    obs.enabled(True)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        progressive.step(scene, cfg, state)
        torch.cuda.synchronize()
        rec["frame_host_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        obs.enabled(spans)
        (integrator.trace_closest, integrator.trace_occluded, integrator._paint_bad,
         intersect.mesh_brute_force, intersect.mesh_brute_force_anyhit) = orig
    return rec


def brute_times(rec, card: str) -> dict:
    """The brute-force engine alone on bounce 2's closest-hit and any-hit
    queries of ``rec``: the kernel (``brute_hits``) and its plain twin, ms
    per call by CUDA events over back-to-back calls and device ms by the
    profiler, beside the bound (every input read once, the output written
    once, ``OPS_PER_TEST`` per (ray, triangle) pair; the engine tests every
    lane, live or not). Raises unless the kernel's results equal the
    twin's bit for bit. Returns the times by query."""
    from tracer_torch.kernels import intersect

    out = {}
    for key, fn, twin in (("closest", intersect.mesh_brute_force,
                           intersect.mesh_brute_force_reference),
                          ("any-hit", intersect.mesh_brute_force_anyhit,
                           intersect.mesh_brute_force_anyhit_reference)):
        rays, verts, idx = rec["brute_args"][key]
        call, plain = lambda: fn(rays, verts, idx), lambda: twin(rays, verts, idx)
        got, want = call(), plain()
        got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
        bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            raise AssertionError(f"the brute-force {key} kernel differs from its twin")
        ms, plain_ms = cuda_events_ms(call, 20), cuda_events_ms(plain, 20)
        dev_ms = profiled_device_ms(call, 20, "brute_hits")
        plain_dev_ms = profiled_device_ms(plain, 20, "elementwise")
        n, T = rays.o.shape[0], idx.shape[0]
        b_ms, b_by = bound_ms(nbytes(rays.o, rays.d, rays.tmin, rays.tmax, verts, idx, *got),
                              n * T * OPS_PER_TEST)
        live = float((rays.tmax > rays.tmin).float().mean())
        log(f"[cornell] brute-force {key} at bounce 2 ({n} lanes, {live:.1%} with a non-empty "
            f"window; {T} triangles): kernel {ms:.4f} ms per call (CUDA events), {dev_ms:.4f} "
            f"ms device (profiler); twin {plain_ms:.4f} ms, {plain_dev_ms:.4f} ms device; "
            f"bound {b_ms:.4f} ms ({b_by}); equal bit for bit; {rec['brute_calls']} "
            f"brute-force calls in the frame; {card}")
        out[key.replace("-", "_")] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                          plain_device_ms=plain_dev_ms, bound_ms=b_ms,
                                          bound_by=b_by)
    return out


def cornell_phase(dev, card: str, kernels) -> dict:
    """Phase 8: path mode in the Cornell box on the brute-force engine (see
    the module docstring). Raises on any failed check. Returns the
    brute-force kernel's times (``brute_times``) and its launches in the
    timed frames."""
    from tracer_torch import obs
    from tracer_torch.kernels import brute_hits
    from tracer_torch.render import progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    counts = [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in kernels]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def sized(name, size):
        desc = with_fixture_model(get_scene(name))
        return dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=size,
                                                                 height=size))

    def run(name, size, frames):
        t0 = time.perf_counter()
        scene, cfg = build_scene(sized(name, size), dev)
        built = time.perf_counter() - t0
        if cfg.traversal != "brute" or scene.tb is not None or cfg.mode != "path":
            raise AssertionError(f"{name} is not on the brute-force path")
        state = progressive.init_state(cfg, dev)
        progressive.step(scene, cfg, state)
        torch.cuda.synchronize()
        names = ("brute.pairs", "brute.kernel_pairs")
        c0 = obs.counters()
        t0 = time.perf_counter()
        start.record()
        for _ in range(frames):
            progressive.step(scene, cfg, state)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / frames * 1e3
        ms = start.elapsed_time(end) / frames
        pairs, kernel_pairs = (obs.counters().get(k, 0) - c0.get(k, 0) for k in names)
        if not pairs or kernel_pairs != pairs:
            raise AssertionError(f"{name}: {kernel_pairs} of {pairs} brute-force pairs in the "
                                 "timed frames ran in the kernel")
        launches = brute_hits.KERNEL_LAUNCHES
        rec = cornell_instrumented(scene, cfg, state)
        if brute_hits.KERNEL_LAUNCHES - launches != rec["brute_calls"]:
            raise AssertionError(f"{name}: {brute_hits.KERNEL_LAUNCHES - launches} brute-force "
                                 f"launches for {rec['brute_calls']} queries")
        rec["launches"] = kernel_pairs // (cfg.width * cfg.height * scene.geom.indices.shape[0])
        acc = state.accum
        log(f"[cornell] {name} {cfg.width}x{cfg.height}, max_depth {cfg.max_depth}, "
            f"{scene.geom.indices.shape[0]} triangles, "
            f"{0 if scene.spheres is None else scene.spheres.radius.shape[0]} spheres, built in "
            f"{built:.2f} s; {frames} frames: {ms:.3f} ms/frame (CUDA events), {host_ms:.3f} "
            f"ms/frame (host clock), primary {cfg.width * cfg.height / (ms * 1e3):.3f} Mpath/s; "
            f"instrumented frame ({rec['frame_host_ms']:.3f} ms, host clock): {rec['bounces']} "
            f"bounces, {rec['segments']} ray segments ({rec['segments'] / (ms * 1e3):.3f} M "
            f"segments/s at the timed ms/frame), {rec['shadow']} shadow rays, truncated lanes "
            f"{rec['bad']}; brute-force kernel launches in the timed frames {rec['launches']}; "
            f"{card}")
        if rec["bad"]:
            raise AssertionError(f"{name}: {rec['bad']} lanes were truncated")
        if acc.shape != (cfg.width * cfg.height, 3) or not bool(torch.isfinite(acc).all()) \
                or not bool((acc >= 0).all()) or not float(acc.max()) > 0:
            raise AssertionError(f"{name}: the accumulator is not finite, non-negative and nonzero")
        if state.iteration != frames + 2:
            raise AssertionError(f"{name}: iteration {state.iteration} after {frames + 2} steps")
        if [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in kernels] != counts:
            raise AssertionError(f"{name} ran a hand kernel other than the brute-force one, "
                                 "or a twin")
        return scene, cfg, state, rec

    # 8a. The main path: W8 E3 at full registry size.
    scene, cfg, state, rec = run("W8 E3 Absorption", 512, 10)
    if (cfg.width, cfg.height, cfg.max_depth) != (512, 512, 10) \
            or scene.geom.indices.shape[0] != 12 or scene.spheres.radius.shape[0] != 2:
        raise AssertionError("the W8 E3 frame is not at full size")
    prof = profile_step(lambda: progressive.step(scene, cfg, state), {})
    if prof:
        log(f"[cornell] profiled W8 E3 frame: {prof['kernels']} kernels, device busy "
            f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms trace (idle "
            f"{prof['idle']:.1%}); {card}")
    else:
        log("[cornell] the profiler recorded no device time")
    times = brute_times(rec, card)
    launches = rec["launches"]

    # 8b. A 32x32 frame against the JAX package's numbers.
    sscene, scfg = build_scene(sized("W8 E3 Absorption", 32), dev)
    stats = path_stats(progressive.render_progressive(sscene, scfg, 2).accum.cpu().numpy())
    log(f"[cornell 32x32] {stats} (JAX: {CORNELL_REF})")
    bad = path_errors(stats, CORNELL_RTOL, CORNELL_REF)
    if bad:
        raise AssertionError("the 32x32 W8 E3 frame disagrees with the JAX package: "
                             + "; ".join(bad))

    # 8c. The other Cornell rows of the slice.
    for name, size in (("W8 E1 Cornell Box Balls", 512), ("W8 E2 Cornell Box Balls", 512),
                       ("W7 E3 Cornell Box", 128)):
        launches += run(name, size, 3)[3]["launches"]
    return dict(times=times, launches=launches)


def same_but_config(a, b) -> bool:
    """Whether descriptors ``a`` and ``b`` differ in their name and
    configuration only (the same model, camera, primitives and assets)."""
    keys = ("model", "model_scale", "camera", "spheres", "planes", "tris", "hdri", "hdri_rgbe",
            "texture", "selection1", "selection2", "bvh_leaf")
    return all(getattr(a, k) == getattr(b, k) for k in keys)


def timed_frames(scene, cfg, state, frames: int) -> tuple[float, float]:
    """``frames`` progressive steps after a synchronize: ms per frame by CUDA
    events and by the host clock."""
    from tracer_torch.render import progressive

    ms, host_ms, _ = timed_steps(lambda: progressive.step(scene, cfg, state), frames)
    return ms, host_ms


def direct_phase(dev, card: str, kernels, dragon) -> dict:
    """Phase 10: direct mode (see the module docstring). ``dragon`` is phase
    4's (scene, cfg, descriptor, primary rays, hit ids). Raises on any
    failed check; returns B1's launches in the phase and its largest error
    against the twin on the shadow rays, for the ``kernels`` line."""
    from tracer_torch.accel import flat
    from tracer_torch.kernels import super_hits, super_occluded
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene, scene_config
    from tracer_torch.scenes.registry import get_scene

    dscene, dcfg, ddesc, rays, ids_dragon = dragon
    frame = (dcfg.width, dcfg.height)

    def counts():
        return [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in kernels]

    def reset():
        for m in kernels:
            m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0

    def checked(name, scene, cfg, state, frames, rec):
        acc = state.accum
        if rec["bad"]:
            raise AssertionError(f"{name}: {rec['bad']} lanes did not converge")
        if acc.shape != (cfg.width * cfg.height, 3) or not bool(torch.isfinite(acc).all()):
            raise AssertionError(f"{name}: the accumulator is not finite")
        if state.iteration != frames + 2:
            raise AssertionError(f"{name}: iteration {state.iteration} after {frames + 2} steps")

    def on_dragon(row_desc, frames):
        """The dragon rows: phase 4's scene under this row's configuration;
        B1 on every frame, never its twin; with shadows the any-hit
        query's kernel too on every frame, never its twin route."""
        if not same_but_config(row_desc, ddesc):
            raise AssertionError(f"{row_desc.name} is not phase 4's dragon under another config")
        cfg = scene_config(row_desc)
        if (cfg.width, cfg.height) != frame or not integrator._mesh_engine(dscene, cfg).seeded:
            raise AssertionError(f"{row_desc.name} is not the 800x450 flat-engine frame")
        state = progressive.init_state(cfg, dev)
        reset()
        per_frame = []
        progressive.step(dscene, cfg, state)
        per_frame.append(super_hits.KERNEL_LAUNCHES)
        ms, host_ms = timed_frames(dscene, cfg, state, frames)
        launches, twin = super_hits.KERNEL_LAUNCHES, super_hits.REFERENCE_CALLS
        occ, occ_twin = super_occluded.KERNEL_LAUNCHES, super_occluded.REFERENCE_CALLS
        if launches < (frames + 1) * per_frame[0] or twin or counts()[1:3] != [(0, 0), (0, 0)]:
            raise AssertionError(f"{row_desc.name} did not run B1 alone on every frame: {counts()}")
        if occ_twin or (occ < frames + 1 if cfg.shadows else occ):
            raise AssertionError(f"{row_desc.name}: the any-hit kernel ran {occ} times over "
                                 f"{frames + 1} frames, its twin route {occ_twin}")
        rec = cornell_instrumented(dscene, cfg, state)
        checked(row_desc.name, dscene, cfg, state, frames, rec)
        prof = profile_step(lambda: progressive.step(dscene, cfg, state),
                            {"b1_ms": "super_hits", "occ_ms": "super_occluded"})
        log(f"[direct] {row_desc.name} {cfg.width}x{cfg.height} (phase 4's dragon), lights "
            f"{cfg.lights}, shadows {cfg.shadows}, ambient {cfg.ambient!r}; {frames} frames after "
            f"1: {ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms/frame (host clock); B1 "
            f"launches {launches} over {frames + 1} frames ({per_frame[0]} in the first), "
            f"any-hit kernel launches {occ}, twin calls {twin + occ_twin}; instrumented frame: "
            f"{rec['shadow']} shadow rays, truncated lanes "
            f"{rec['bad']}; " + (f"profiled frame: {prof['kernels']} kernels, device busy "
                                 f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms trace "
                                 f"(idle {prof['idle']:.1%}), B1 {prof['b1_ms']:.4f} ms, any-hit "
                                 f"kernel {prof['occ_ms']:.4f} ms"
                                 if prof else "the profiler recorded no device time")
            + f"; {card}")
        return cfg, state, launches, occ

    # 10a. W6 E1 Dragon: the mix_ka ambient on phase 4's dragon.
    w6 = get_scene("W6 E1 Dragon")
    cfg6, state6, b1_w6, _ = on_dragon(w6, 10)
    caught = []
    closest = flat.closest_hit
    flat.closest_hit = lambda *a, **kw: caught.append(closest(*a, **kw)) or caught[-1]
    try:
        progressive.step(dscene, cfg6, state6)
    finally:
        flat.closest_hit = closest
    (_, ids6, conv6), = caught
    if not torch.equal(ids6, ids_dragon) or not bool(conv6.all()):
        raise AssertionError(f"W6 E1 Dragon's hit ids differ from Project: Dragon's on "
                             f"{int((ids6 != ids_dragon).sum())} lanes")
    log("[direct] W6 E1 Dragon's hit ids equal Project: Dragon's bit for bit; every lane "
        "converged")

    # 10b. The shadowed frame on the dragon: W5 E3 Teapot's configuration
    # (the directional light with shadow rays) on the stand-in; B1 for the
    # primary rays, the any-hit query's kernel for the shadow rays, each
    # query held afterwards against the twin route on the card.
    sdesc = with_standin_mesh(get_scene("W5 E3 Teapot"), "dragon.obj")
    with caught_queries() as queries:
        scfg, sstate, b1_shadow, occ_shadow = on_dragon(sdesc, 10)
    # One more frame with spies: its shadow rays, and each hit kernel's
    # CUDA-event span (the frame is not a timed one).
    shadow, spans = [], []
    any_hit, hits2, occluded = flat.any_hit, super_hits.hits2, super_occluded.occluded

    def spanned(fn, what):
        def run(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            spans.append((what, ev))
            return out
        return run

    flat.any_hit = lambda r, *a, **kw: shadow.append(r) or any_hit(r, *a, **kw)
    super_hits.hits2 = spanned(hits2, "B1")
    super_occluded.occluded = spanned(occluded, "any-hit")
    try:
        with caught_queries() as timed_query:
            progressive.step(dscene, scfg, sstate)
    finally:
        flat.any_hit, super_hits.hits2, super_occluded.occluded = any_hit, hits2, occluded
    torch.cuda.synchronize()
    span = {w: [e[0].elapsed_time(e[1]) for what, e in spans if what == w] for w in ("B1", "any-hit")}
    log(f"[direct] shadowed dragon frame's hit kernels: B1 {len(span['B1'])} launch(es) "
        f"{sum(span['B1']):.3f} ms, any-hit kernel {len(span['any-hit'])} launch(es) "
        f"{sum(span['any-hit']):.3f} ms (CUDA events); {card}")
    # Every shadowed frame's query (the 11 counted, the instrumented, the
    # profiled and the spied one) against the twin route on B1's kernel;
    # the spied frame's also against the plain twin route.
    check_queries("shadowed dragon frames", queries + timed_query, super_hits.hits2)
    (srays,), ((tb_s, em, max_rounds, got),) = shadow, timed_query
    occ_counts = torch.zeros(3, dtype=torch.int64, device=dev)
    super_occluded.occluded(tb_s, em, max_rounds, counts=occ_counts)
    st = {}
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev[0].record()
    want = super_occluded.occluded_reference(tb_s, em, max_rounds, stats=st)
    ev[1].record()
    torch.cuda.synchronize()
    occ_plain_ms = ev[0].elapsed_time(ev[1])
    occ_bad = occlusion_mismatch(em, got, want)
    if occ_bad or em.untile(got[1]).numel() != srays.o.shape[0] or not bool(got[2].all()):
        raise AssertionError(f"the spied frame's shadow rays: {occ_bad} lanes differ from the "
                             "plain twin route, or a super-tile did not converge")
    blocked = em.untile(want[1]) > 0.0
    log(f"[direct] shadowed dragon: {int(blocked.sum())} of {blocked.numel()} shadow rays "
        f"blocked, flags and converged equal to the plain twin route's on every one; "
        f"{em.n_super} super-tiles x {em.ids.shape[1]} slots, mean "
        f"{float(em.en.float().mean()):.1f} emissions, {int(em.overflow.sum())} super-tiles "
        f"overflowing; the twin route's counts: {st['visits']} visits, {st['live_tests']} live "
        f"tests; the kernel's: {int(occ_counts[0])} work items, {int(occ_counts[1])} visits, "
        f"{int(occ_counts[2])} live tests")
    n_open, n_pairs = check_sweep_gates("the shadowed dragon's sweep gates", tb_s, em, max_rounds)
    # The any-hit query alone on those emissions: the kernel against the old
    # route (B1 over the culled list, then the id-order rounds) and B1's
    # any-hit launch on the culled list.
    occ_ms = cuda_events_ms(lambda: super_occluded.occluded(tb_s, em, max_rounds), 20)
    old_ms = cuda_events_ms(lambda: super_occluded.occluded_reference(
        tb_s, em, max_rounds, hits=super_hits.hits2), 3)
    occ_bound, occ_by = occlusion_bound(tb_s, em, max_rounds, st["live_tests"])
    occ_own, occ_own_by = occlusion_bound(tb_s, em, max_rounds, int(occ_counts[2]))
    log(f"[time] the shadowed dragon's any-hit query: kernel {occ_ms:.4f} ms, old route "
        f"{old_ms:.3f} ms ({old_ms / occ_ms:.1f}x), plain twin route {occ_plain_ms:.1f} ms, "
        f"bound over the twin route's live tests {occ_bound:.4f} ms ({occ_by}; "
        f"{st['live_tests']} tests), over the kernel's own (its bound_ms) {occ_own:.4f} ms "
        f"({occ_own_by}; "
        f"{int(occ_counts[2])} tests, {int(occ_counts[2]) / (occ_ms * 1e9):.3f} T live Moller "
        f"tests/s); {card}")
    args = frame_args(em, tb_s)
    err = compare("dragon shadow rays any-hit", super_hits.hits2(*args, True),
                  super_hits.hits2_reference(*args, True))
    any_ms = cuda_events_ms(lambda: super_hits.hits2(*args, True), 5)
    st = {}
    super_hits.hits2_reference(*args, True, stats=st)
    b_ms, b_by = b1_bound(args, st["live_tests"])
    log(f"[time] hits2 any-hit, the shadowed dragon's culled emissions: kernel {any_ms:.4f} ms, "
        f"bound over live tests {b_ms:.4f} ms ({b_by}; {st['live_tests']} tests); the twin's "
        f"counts: {st['staged']} staged slots, {st['rounds']} rounds, {st['visits']} visits, "
        f"per super-tile visits max {int(st['super_visits'].max())}; {card}")
    # The list alone (round cap 1: no sweep), the path of a mesh whose
    # super-tiles keep at most K treelets: the kernel against B1's any-hit
    # launch on the same culled list, after a bitwise check.
    list_bad = occlusion_mismatch(em, super_occluded.occluded(tb_s, em, 1),
                                  super_occluded.occluded_reference(tb_s, em, 1,
                                                                    hits=super_hits.hits2))
    if list_bad:
        raise AssertionError(f"the shadowed dragon's culled list alone: {list_bad} lanes "
                             "differ from B1's any-hit launch")
    list_ms = cuda_events_ms(lambda: super_occluded.occluded(tb_s, em, 1), 20)
    log(f"[time] the culled list alone (round cap 1, no sweep): the any-hit kernel "
        f"{list_ms:.4f} ms, B1's any-hit launch {any_ms:.4f} ms ({any_ms / list_ms:.2f}x); "
        f"flags equal bit for bit; {card}")

    # 10c. W6 E3 (area lights, mirror, glossy; brute force) at 512x512,
    # 1 + 10 frames; the other Cornell rows and worksheets 1-3, 1 + 3.
    rows = [("W6 E3 Cornell Box", 10)] + [(r, 3) for r in (
        "W5 E4 Cornell Box", "W5 E5 Cornell Box", "W6 E2 Cornell Box", "W7 E1 Cornell Box",
        "W7 E2 Cornell Box", "W1 E1", "W1 E2", "W1 E3", "W1 E4", "W1 E5", "W1 E6", "W2 E1",
        "W2 E2", "W2 E3", "W2 E4", "W2 E5", "W3 E1", "W3 E2", "W3 E3", "W3 E4")]
    for name, frames in rows:
        desc = with_fixture_model(get_scene(name))
        scene, cfg = build_scene(desc, dev)
        if (cfg.width, cfg.height) != (512, 512) or cfg.mode != "direct" or scene.tb is not None:
            raise AssertionError(f"{name} is not the 512x512 direct frame without treelets")
        state = progressive.init_state(cfg, dev)
        reset()
        progressive.step(scene, cfg, state)
        ms, host_ms = timed_frames(scene, cfg, state, frames)
        rec = cornell_instrumented(scene, cfg, state)
        checked(name, scene, cfg, state, frames, rec)
        if counts() != [(0, 0)] * len(kernels):
            raise AssertionError(f"{name} ran a hand kernel or a twin: {counts()}")
        log(f"[direct] {name} {cfg.width}x{cfg.height}, shaders {cfg.possible_shaders}, lights "
            f"{cfg.lights}, subdivs {cfg.subdivs}; {frames} frames after 1: {ms:.3f} ms/frame "
            f"(CUDA events), {host_ms:.3f} ms/frame (host clock); instrumented frame: "
            f"{rec['bounces']} bounces, {rec['shadow']} shadow rays, {rec['brute_calls']} "
            f"brute-force calls, truncated lanes {rec['bad']}; {card}")

    # 10d. 32x32 frames against the JAX package's numbers.
    for name, ref in DIRECT_REF.items():
        desc = with_fixture_model(get_scene(name))
        desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=32, height=32))
        scene, cfg = build_scene(desc, dev)
        stats = path_stats(progressive.render_progressive(scene, cfg, 2).accum.cpu().numpy())
        log(f"[direct 32x32] {name}: {stats} (JAX: {ref})")
        bad = path_errors(stats, DIRECT_RTOL, ref)
        if bad:
            raise AssertionError(f"the 32x32 {name} frame disagrees with the JAX package: "
                                 + "; ".join(bad))
    return dict(b1_launches=b1_w6 + b1_shadow, b1_err=err, occ_launches=occ_shadow,
                occ_bad=occ_bad, occ_ms=occ_ms, occ_old_ms=old_ms, occ_plain_ms=occ_plain_ms,
                occ_bound_ms=occ_own, occ_by=occ_own_by, occ_twin_bound_ms=occ_bound,
                occ_list_ms=list_ms, occ_b1_list_ms=any_ms, occ_live_tests=int(occ_counts[2]),
                occ_open_pairs=n_open, occ_sweep_pairs=n_pairs)


def timed_steps(step, n: int) -> tuple[float, float, int]:
    """``n`` calls of ``step`` after a synchronize: ms per call by CUDA events
    and by the host clock, and the peak of allocated device memory over them
    (bytes)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        step()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / n, (time.perf_counter() - t0) / n * 1e3,
            torch.cuda.max_memory_allocated())


def grad_checks(name: str, g, prev, nonzero) -> dict:
    """A scene gradient's checks: every leaf finite, the leaves of
    ``nonzero`` nonzero, and ``g`` bitwise equal to ``prev`` (an earlier
    step on the same inputs) on every leaf. Returns ``g`` as arrays."""
    from tracer_torch import convert

    ga, gp = convert.grads_to_arrays(g), convert.grads_to_arrays(prev)
    if ga.keys() != gp.keys():
        raise AssertionError(f"{name}: two steps returned different leaves")
    for k, a in ga.items():
        if not np.isfinite(a).all():
            raise AssertionError(f"{name} {k}: non-finite gradient")
        if not np.array_equal(a.view(np.int32), gp[k].view(np.int32)):
            raise AssertionError(f"{name} {k}: two gradient steps differ")
    for k in nonzero:
        if not np.abs(ga[k]).sum() > 0:
            raise AssertionError(f"{name} {k}: gradient is zero")
    return ga


def pgrad_phase(dev, card: str, kernels) -> dict:
    """Phase 9: path-mode gradients through the ``scan`` bounce loop (see
    the module docstring). Raises on any failed check; returns the kernel
    launches and B2's largest error for the ``kernels`` line."""
    from tracer_torch import convert
    from tracer_torch.diff import grad as G
    from tracer_torch.kernels import scatter_vn, super_hits, texel_place, treelet_hits
    from tracer_torch.render import integrator
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    def sized(name, size, **kw):
        desc = get_scene(name)
        if os.path.basename(desc.model or "") in FIXTURE_MODELS:
            desc = with_fixture_model(desc)
        return dataclasses.replace(desc, cfg=dataclasses.replace(
            desc.cfg, width=size, height=size, loop="scan", **kw))

    def counts():
        return [(m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) for m in kernels]

    def reset():
        for m in kernels:
            m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0

    gib = 2.0 ** 30

    # 9a. W8 E3 Absorption at 512x512: 1 warm-up and 3 timed steps.
    desc = sized("W8 E3 Absorption", 512)
    scene, cfg = build_scene(desc, dev)
    if (cfg.width, cfg.height, cfg.max_depth, cfg.remat) != (512, 512, 10, "none") \
            or cfg.traversal != "brute" or scene.spheres.radius.shape[0] != 2:
        raise AssertionError("the W8 E3 gradient step is not at full size")
    n = cfg.width * cfg.height
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    out = {}
    step = lambda c=cfg: out.__setitem__("g", G.grad_scene(scene, c, target))
    reset()
    step()
    first = out["g"]
    steps = 3
    ms, host_ms, peak = timed_steps(step, steps)
    if counts() != [(0, 0)] * len(kernels):
        raise AssertionError(f"the W8 E3 gradient ran a hand kernel or a twin: {counts()}")
    log(f"[pgrad] W8 E3 Absorption {cfg.width}x{cfg.height}, max_depth {cfg.max_depth}, "
        f"loop scan, remat none, target zeros; {steps} steps after 1: {ms:.3f} ms/step (CUDA "
        f"events), {host_ms:.3f} ms/step (host clock), {n / (ms * 1e-3):.1f} paths/s, peak "
        f"memory {peak / gib:.3f} GiB (max_memory_allocated over the timed steps); {card}")
    ga = grad_checks("W8 E3", out["g"], first, ("materials.diffuse", "materials.emission",
                                                 "geom.vertices", "spheres.center", "camera.eye"))
    log("[pgrad] every leaf finite; two steps equal bitwise on every leaf; "
        + ", ".join(f"{k} sum|g| {float(np.abs(a).sum()):.6g}" for k, a in ga.items()
                    if np.abs(a).sum() > 0))
    bounces = []
    bounce = integrator._bounce
    integrator._bounce = lambda *a: bounces.append(1) or bounce(*a)
    try:
        step()
    finally:
        integrator._bounce = bounce
    prof = profile_step(step, {})
    with torch.no_grad():
        fwd = profile_step(lambda: G.l2_loss(scene, cfg, target).item(), {})
    if prof and fwd:
        log(f"[pgrad] profiled W8 E3 step: {len(bounces)} bounces, {prof['kernels']} kernels, "
            f"device busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms trace (idle "
            f"{prof['idle']:.1%}); the forward alone (no graph, profiled apart) "
            f"{fwd['kernels']} kernels, "
            f"busy {fwd['busy_ms']:.3f} ms, so the backward is "
            f"{1.0 - fwd['busy_ms'] / prof['busy_ms']:.1%} of the step's busy time; {card}")
    else:
        log("[pgrad] the profiler recorded no device time")
    full = dataclasses.replace(cfg, remat="full")
    step(full)
    f_ms, f_host_ms, f_peak = timed_steps(lambda: step(full), 1)
    grad_checks("W8 E3 remat full", out["g"], first, ())
    log(f"[pgrad] W8 E3 remat full, 1 step after 1: {f_ms:.3f} ms/step (CUDA events), "
        f"{f_host_ms:.3f} ms/step (host clock), peak memory {f_peak / gib:.3f} GiB; beside "
        f"remat none {ms:.3f} ms/step and {peak / gib:.3f} GiB; equal to it bitwise; {card}")

    # 9b. fd_check at 64x64 and the 16x16 gradient against the JAX package's.
    sscene, scfg = build_scene(sized("W8 E3 Absorption", 64), dev)

    def set_diffuse(s, leaf):
        return dataclasses.replace(s, materials=dataclasses.replace(s.materials, diffuse=leaf))

    ad, fd = G.fd_check(sscene, scfg, torch.zeros((64 * 64, 3), device=dev),
                        lambda s: s.materials.diffuse, set_diffuse,
                        torch.ones_like(sscene.materials.diffuse) * 0.01, eps=3e-2, rtol=0.15)
    log(f"[pgrad] W8 E3 64x64 fd_check materials.diffuse (eps 3e-2, rtol 0.15): ad {ad!r} "
        f"fd {fd!r}")
    sscene, scfg = build_scene(sized("W8 E3 Absorption", 16), dev)
    g16 = G.grad_scene(sscene, scfg, torch.zeros((16 * 16, 3), device=dev))
    stats = grad_stats(convert.grads_to_arrays(g16))
    bad = bunny_grad_errors(stats, CORNELL_GRAD_RTOL, CORNELL_GRAD_REF, CORNELL_GRAD_ZERO)
    for k in CORNELL_GRAD_REF:
        log(f"[pgrad 16x16] {k}: sum, sum|x|, sum x^2 = {stats[k]} (JAX: {CORNELL_GRAD_REF[k]})")
    if bad:
        raise AssertionError("the 16x16 W8 E3 gradient disagrees with the JAX package: "
                             + "; ".join(bad))
    log(f"[pgrad 16x16] agrees with the JAX package at rtol {CORNELL_GRAD_RTOL}")
    if counts() != [(0, 0)] * len(kernels):
        raise AssertionError(f"the W8 E3 gradients ran a hand kernel or a twin: {counts()}")

    # 9c. W9 E1 Bunny at 256x256 (cut from 512x512), depth 50, seeded environment.
    wdesc = sized("W9 E1 Bunny", 256)
    wscene, wcfg = build_scene(wdesc, dev)
    wscene = with_seeded_env(wscene, wdesc, dev)
    if wcfg.max_depth != 50 or wscene.geom.indices.shape[0] != 69_564:
        raise AssertionError("the W9 E1 gradient step is not at its depth and mesh")
    wn = wcfg.width * wcfg.height
    wtarget = torch.zeros((wn, 3), dtype=torch.float32, device=dev)
    wstep = lambda: out.__setitem__("w", G.grad_scene(wscene, wcfg, wtarget))
    reset()
    texel_place.KERNEL_LAUNCHES = texel_place.REFERENCE_CALLS = 0
    wstep()
    wfirst = out["w"]
    per_step = [treelet_hits.KERNEL_LAUNCHES, scatter_vn.KERNEL_LAUNCHES,
                texel_place.KERNEL_LAUNCHES]
    w_ms, w_host_ms, w_peak = timed_steps(wstep, 2)
    b3_launches, b2_launches = treelet_hits.KERNEL_LAUNCHES, scatter_vn.KERNEL_LAUNCHES
    texel_launches = texel_place.KERNEL_LAUNCHES
    twin_calls = sum(m.REFERENCE_CALLS for m in (*kernels, texel_place))
    ga = grad_checks("W9 E1", out["w"], wfirst, ("camera.eye", "env.data"))
    # One more step with spies: bounces, B2's sorted corner streams and the
    # texel placement's sorted streams.
    streams, bounces, texel_streams = [], [], []
    place, bounce, tplace = scatter_vn.segment_place, integrator._bounce, texel_place.place
    scatter_vn.segment_place = lambda *a: streams.append(a) or place(*a)
    integrator._bounce = lambda *a: bounces.append(1) or bounce(*a)
    texel_place.place = lambda *a: texel_streams.append(a) or tplace(*a)
    try:
        wstep()
    finally:
        scatter_vn.segment_place, integrator._bounce, texel_place.place = place, bounce, tplace
    rows = [a[0].shape[0] for a in streams]
    log(f"[pgrad] W9 E1 Bunny {wcfg.width}x{wcfg.height} (cut from 512x512), max_depth "
        f"{wcfg.max_depth}, seeded environment, loop scan, target zeros; 2 steps after 1: "
        f"{w_ms:.3f} ms/step (CUDA events), {w_host_ms:.3f} ms/step (host clock), peak memory "
        f"{w_peak / gib:.3f} GiB; {len(bounces)} bounces per step; B3 launches {b3_launches} "
        f"and B2 launches {b2_launches} over 3 steps (first step {per_step}), twin calls "
        f"{twin_calls}; B2 rows per launch {rows} (mean {np.mean(rows):.0f}); texel_place "
        f"launches {texel_launches} over 3 steps (first step {per_step[2]}), rows per launch "
        f"{[a[0].shape[0] for a in texel_streams]}; {card}")
    if super_hits.KERNEL_LAUNCHES or twin_calls:
        raise AssertionError("the W9 E1 gradient ran B1 or a twin")
    # B2 places the rows of every bounce but the last: the last bounce's rows
    # reach only the next ray and throughput, which no bounce reads, so the
    # backward never reaches their fetch (W9 E1 has no next-event estimation).
    if per_step[1] != len(bounces) - 1 or b2_launches != 3 * per_step[1] or len(streams) != \
            per_step[1] or b3_launches < 3 * len(bounces):
        raise AssertionError("B2 did not run once per bounce but the last, or B3 not on every "
                             "bounce")
    # Every bounce looks up the environment for every lane (4 taps).
    if per_step[2] != len(bounces) or texel_launches != 3 * per_step[2] or \
            [a[0].shape[0] for a in texel_streams] != [4 * wn] * len(bounces):
        raise AssertionError("the texel placement did not run once per bounce on every lane")
    log("[pgrad] W9 E1 every leaf finite; two steps equal bitwise on every leaf; "
        + ", ".join(f"{k} sum|g| {float(np.abs(a).sum()):.6g}" for k, a in ga.items()
                    if np.abs(a).sum() > 0))

    # 9d. B2 against its twin on a path-lane stream: bounce 2's sorted corners
    # (the backward places the bounces last first), with their real
    # cotangents and with seeded ones on the same ids.
    sids, svals, v = streams[-2]
    nonzero = int((svals != 0).any(dim=1).sum())
    err = check_segment_place(f"W9 E1 path gradient bounce 2 ({nonzero} nonzero rows)",
                              sids, svals, v)
    rs = np.random.RandomState(0)
    seeded = torch.as_tensor(rs.standard_normal(tuple(svals.shape)).astype(np.float32),
                             device=dev)
    err = max(err, check_segment_place("W9 E1 bounce 2 ids, seeded cotangents", sids, seeded, v))
    # 9e. The texel placement against its twin on bounce 1's lookup (placed
    # last): the camera rays' crowded texels, with their real cotangents.
    check_texel_place("W9 E1 path gradient bounce 1 lookup", *texel_streams[-1])
    return dict(b2_launches=b2_launches, b3_launches=b3_launches, b2_err=err,
                texel_launches=texel_launches)


def sun_phase(dev, card: str, kernels) -> dict:
    """Phase 11: ``W9 E3`` on the bunny stand-in (see the module
    docstring). Raises on any failed check; returns B3's launches in the
    timed frames and its largest error against the twin."""
    from tracer_torch.kernels import treelet_hits
    from tracer_torch.render import progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    for m in kernels:
        m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0
    desc = sun_desc(get_scene)
    t0 = time.perf_counter()
    scene, cfg = build_scene(desc, dev)
    scene = with_seeded_env(scene, desc, dev)
    log(f"[sun] {desc.name} {cfg.width}x{cfg.height}, max_depth {cfg.max_depth}, lights "
        f"{cfg.lights}: {scene.geom.indices.shape[0]} triangles, {scene.tb.NT} treelets, "
        f"built in {time.perf_counter() - t0:.2f} s")
    if (cfg.width, cfg.height, cfg.max_depth) != (800, 450, 50) or cfg.mode != "path" \
            or cfg.lights != ("directional",) or scene.geom.indices.shape[0] != 69_564:
        raise AssertionError("the W9 E3 frame is not at full size")
    state = progressive.init_state(cfg, dev)
    progressive.step(scene, cfg, state)
    per_frame = [treelet_hits.KERNEL_LAUNCHES]
    frames = 3

    def frame():
        progressive.step(scene, cfg, state)
        per_frame.append(treelet_hits.KERNEL_LAUNCHES)

    ms, host_ms, _ = timed_steps(frame, frames)
    launches, ref = treelet_hits.KERNEL_LAUNCHES, treelet_hits.REFERENCE_CALLS
    if min(np.diff([0] + per_frame)) < 1 or ref or kernels[0].KERNEL_LAUNCHES \
            or kernels[1].KERNEL_LAUNCHES:
        raise AssertionError(f"a W9 E3 frame did not run on B3 alone (launches {per_frame}, "
                             f"twin calls {ref})")
    rec = instrumented_step(scene, cfg, state)
    n_any = rec["any_hit_rounds"]
    n_closest = len(rec["rounds"]) - n_any
    log(f"[sun] {frames} frames: {ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms/frame (host "
        f"clock), primary {cfg.width * cfg.height / (ms * 1e3):.3f} Mpath/s; B3 launches "
        f"{launches} over {frames + 1} frames (cumulative {per_frame}), twin calls {ref}; "
        f"instrumented frame ({rec['frame_host_ms']:.3f} ms, host clock): {rec['bounces']} "
        f"bounces, {rec['segments']} ray segments, {rec['shadow']} shadow rays, B3 rounds "
        f"{n_closest} closest-hit and {n_any} any-hit, phase A {rec['phase_a_host_ms']:.3f} ms "
        f"host clock, B3 {sum(rec['b3_ms']):.3f} ms in all; truncated lanes {rec['bad']}; {card}")
    acc = state.accum
    if rec["bad"] or not n_closest or not n_any or not rec["shadow"]:
        raise AssertionError("W9 E3 truncated a lane, or ran no closest-hit or any-hit round")
    if not bool(torch.isfinite(acc).all()) or not bool((acc >= 0).all()) \
            or not float(acc.max()) > 0 or state.iteration != frames + 2:
        raise AssertionError("the W9 E3 accumulator is not finite, non-negative and nonzero")
    # B3 against its twin on the first any-hit round of bounce 1 (the sun's
    # shadow rays and the holdout's probe).
    (_, real), = [r for r in rec["rounds"] if r[1][-1]][:1]
    args = tuple(real[i] for i in (0, 1, 3, 4, 5, 6, 7, 8))
    err = compare("B3 W9 E3 any-hit", treelet_hits.hits(*args, True),
                  treelet_hits.hits_reference(*args, True))
    prof = profile_step(lambda: progressive.step(scene, cfg, state),
                        {"b3_ms": "treelet_hits_kernel"})
    if not prof:
        raise AssertionError("the profiler recorded no device time in the W9 E3 frame")
    log(f"[sun] profiled frame: {prof['kernels']} kernels, device busy {prof['busy_ms']:.3f} ms "
        f"of a {prof['span_ms']:.3f} ms trace (idle {prof['idle']:.1%}), B3 "
        f"{prof['b3_ms']:.3f} ms; {card}")

    # 32x32 frames, both configurations: the card equals the CPU bit for bit
    # and meets the JAX package's numbers.
    for key, lit in (("row", False), ("lit plane", True)):
        accs = []
        for d in (dev, "cpu"):
            sd = sun_desc(get_scene, lit, 32)
            sscene, scfg = build_scene(sd, d)
            sst = progressive.render_progressive(with_seeded_env(sscene, sd, d), scfg, 2)
            accs.append(sst.accum.cpu())
        stats = path_stats(accs[0].numpy())
        log(f"[sun 32x32 {key}] {stats} (JAX: {SUN_REF[key]})")
        if not torch.equal(accs[0].view(torch.int32), accs[1].view(torch.int32)):
            raise AssertionError(f"the 32x32 W9 E3 {key} frame on the card differs from the CPU's")
        bad = path_errors(stats, SUN_RTOL, SUN_REF[key])
        if bad:
            raise AssertionError(f"the 32x32 W9 E3 {key} frame disagrees with the JAX package: "
                                 + "; ".join(bad))
    log("[sun] 32x32 frames: the card equals the CPU bit for bit and meets SUN_REF")
    return dict(b3_launches=launches, b3_err=err)


def cli_phase(dev, card: str, kernels) -> dict:
    """Phase 12: the CLI in process on ``Project: Dragon`` (see the module
    docstring). Raises on any failed check; returns B1's launches in the
    CLI's runs."""
    import contextlib
    import io as stdio
    import shutil

    from tracer_torch import cli
    from tracer_torch import io as tio
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes import build as build_mod
    from tracer_torch.scenes.registry import get_scene

    out = Path(__file__).resolve().parent / "build" / "tracer_torch" / "smoke-cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    os.environ["TRACER_SCENE_CACHE"] = str(out / "scene-cache")
    step, built = progressive.step, build_mod.build_scene
    for m in kernels:
        m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0

    def run(name, argv):
        """``cli.main(argv)`` with its stderr echoed; returns the seconds
        from the call to the end of its first frame and the build's
        stages."""
        first, stages = [], {}

        def timed_step(*a):
            r = step(*a)
            if not first:
                torch.cuda.synchronize()
                first.append(time.perf_counter())
            return r

        def timed_build(*a, **kw):
            r = built(*a, **kw)
            stages.update(kw.get("timings") or {})
            return r

        progressive.step, build_mod.build_scene = timed_step, timed_build
        err = stdio.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main(argv)
        finally:
            progressive.step, build_mod.build_scene = step, built
        for line in err.getvalue().splitlines():
            log(f"  [{name}] {line}")
        if rc != 0:
            raise AssertionError(f"the CLI's {name} run exited {rc}")
        return (first[0] - t0 if first else None), stages

    dragon = ["--scene", "Project: Dragon", "--stats-every", "0"]
    a_npz, b_npz, ck, png = (str(out / n) for n in ("a.npz", "b.npz", "ck.npz", "a.png"))
    cold, cold_st = run("straight, cold cache", dragon + ["--samples", "8", "--out-npz", a_npz,
                                                          "--out", png])
    warm, warm_st = run("checkpoint, warm cache", dragon + ["--samples", "4", "--checkpoint", ck])
    run("resume", dragon + ["--samples", "8", "--checkpoint", ck, "--resume", "--out-npz", b_npz])
    launches, ref = kernels[0].KERNEL_LAUNCHES, sum(m.REFERENCE_CALLS for m in kernels)
    fmt = lambda st: ", ".join(f"{k}={v:.3f}s" for k, v in st.items())
    log(f"[cli] Project: Dragon 800x450: time to first frame {cold:.3f} s with a cold scene "
        f"cache (build {fmt(cold_st)}), {warm:.3f} s warm (build {fmt(warm_st)}); "
        f"B1 launches {launches} over 16 frames, twin calls {ref}; {card}")
    if launches < 16 or ref:
        raise AssertionError("the CLI's dragon frames did not run on B1 alone")
    with np.load(a_npz) as a, np.load(b_npz) as b:
        if int(a["iteration"]) != 8 or int(b["iteration"]) != 8 \
                or a["image"].shape != (450, 800, 3) \
                or not np.array_equal(a["image"].view(np.uint32), b["image"].view(np.uint32)):
            raise AssertionError("checkpoint and resume differ from the straight run")
        lin = a["image"]
    cfg = build_mod.scene_config(get_scene("Project: Dragon"))
    disp = integrator.to_display(torch.as_tensor(lin.reshape(-1, 3), device=dev), cfg)
    want = np.clip(disp.cpu().numpy().reshape(450, 800, 3) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    got = tio.read_png(png)
    if not np.array_equal(got[..., :3], want) or not (got[..., 3] == 255).all():
        raise AssertionError("the --out PNG does not decode to the rounded display image")
    log("[cli] resumed 4 + 4 equals the straight 8 bit for bit; the --out PNG decodes to the "
        "rounded display image")

    # --interactive over a pipe, in a child process.
    repl_png = out / "repl.png"
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "tracer_torch.cli", "--scene", "W1 E6", "--interactive"],
        input=f"c 2.0\nm1 5\nr 2\nsave {repl_png}\nq\n", capture_output=True, text=True,
        timeout=300, env=env, cwd=Path(__file__).resolve().parent)
    for line in child.stderr.splitlines():
        log(f"  [interactive] {line}")
    if child.returncode or "iteration=3" not in child.stderr \
            or tio.read_png(str(repl_png)).shape != (512, 512, 4):
        raise AssertionError("the interactive CLI failed")
    log(f"[cli] --interactive over a pipe: W1 E6, c 2.0, m1 5, r 2, save, q in "
        f"{time.perf_counter() - t0:.2f} s (child process)")

    # --sharded (a one-rank NCCL group): straight, then checkpoint and resume.
    s_npz, r_npz, ck2 = (str(out / n) for n in ("s.npz", "r.npz", "ck2.npz"))
    before = kernels[0].KERNEL_LAUNCHES
    run("sharded", dragon + ["--sharded", "--samples", "8", "--out-npz", s_npz])
    run("sharded checkpoint", dragon + ["--sharded", "--samples", "4", "--checkpoint", ck2])
    run("sharded resume", dragon + ["--sharded", "--samples", "8", "--checkpoint", ck2,
                                    "--resume", "--out-npz", r_npz])
    s_launches = kernels[0].KERNEL_LAUNCHES - before
    if s_launches < 16 or sum(m.REFERENCE_CALLS for m in kernels):
        raise AssertionError("the CLI's sharded dragon frames did not run on B1 alone")
    with np.load(a_npz) as a:
        for name in (s_npz, r_npz):
            with np.load(name) as z:
                if int(z["iteration"]) != 8 or not np.array_equal(
                        z["image"].view(np.uint32), a["image"].view(np.uint32)):
                    raise AssertionError(f"--sharded ({Path(name).name}) differs from the "
                                         "unsharded image")
    log(f"[cli] --sharded (one rank): straight 8 and checkpointed 4 + resumed 4 each equal the "
        f"unsharded image bit for bit; B1 launches {s_launches} over 16 frames")
    del os.environ["TRACER_SCENE_CACHE"]
    return dict(b1_launches=kernels[0].KERNEL_LAUNCHES)


def dgrad_phase(dev, card: str, kernels, dragon) -> dict:
    """Phase 14: direct-mode gradients (see the module docstring). ``dragon``
    is phase 4's (scene, cfg, descriptor, primary rays, hit ids). Raises on
    any failed check; returns B1's and B2's launches in the phase."""
    from tracer_torch import convert
    from tracer_torch.diff import grad as G
    from tracer_torch.kernels import scatter_vn, super_hits, super_occluded, treelet_hits
    from tracer_torch.render import texture as tex
    from tracer_torch.scenes.build import build_scene, scene_config
    from tracer_torch.scenes.registry import get_scene

    dscene, _, ddesc, _, _ = dragon

    def reset():
        for m in kernels:
            m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0

    def twin_calls():
        return sum(m.REFERENCE_CALLS for m in kernels)

    def zeros(cfg):
        return torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32, device=dev)

    def on_dragon(row_desc, steps, nonzero):
        """``steps`` timed gradient steps after one of phase 4's dragon under
        this row's configuration: each runs B1 and B2 and no twin."""
        if not same_but_config(row_desc, ddesc):
            raise AssertionError(f"{row_desc.name} is not phase 4's dragon under another config")
        cfg = dataclasses.replace(scene_config(row_desc), loop="scan")
        if G.not_differentiated(dscene, cfg):
            raise AssertionError(f"{row_desc.name}: {G.not_differentiated(dscene, cfg)}")
        target = zeros(cfg)
        reset()
        out, per_step = [], []

        def step():
            out.append(G.grad_scene(dscene, cfg, target))
            del out[:-2]
            per_step.append((super_hits.KERNEL_LAUNCHES, scatter_vn.KERNEL_LAUNCHES))

        step()
        ms, host_ms, peak = timed_steps(step, steps)
        b1, b2 = super_hits.KERNEL_LAUNCHES, scatter_vn.KERNEL_LAUNCHES
        runs = np.diff(np.array([(0, 0)] + per_step), axis=0)
        if (runs < 1).any() or twin_calls() or treelet_hits.KERNEL_LAUNCHES:
            raise AssertionError(f"{row_desc.name}: a step did not run B1 and B2 alone "
                                 f"(per step {runs.tolist()}, twin calls {twin_calls()})")
        ga = grad_checks(row_desc.name, out[-1], out[-2], nonzero)
        log(f"[dgrad] {row_desc.name} {cfg.width}x{cfg.height} (phase 4's dragon), lights "
            f"{cfg.lights}, shadows {cfg.shadows}, ambient {cfg.ambient!r}: {steps} steps after "
            f"1: {ms:.3f} ms/step (CUDA events), {host_ms:.3f} ms/step (host clock), peak "
            f"{peak / 2**30:.3f} GiB; B1 launches {b1}, B2 launches {b2} over {steps + 1} steps "
            f"(per step {runs[0].tolist()}), twin calls 0; every leaf finite, two steps equal "
            f"bitwise; " + ", ".join(f"{k} sum|g| {float(np.abs(ga[k]).sum()):.6g}"
                                     for k in nonzero) + f"; {card}")
        return cfg, target, b1, b2

    # 14a. W6 E1 Dragon's gradient step: B1 forward, B2 backward.
    nonzero = ("geom.vertices", "geom.normals", "materials.diffuse", "camera.eye")
    cfg6, target6, b1_w6, b2_w6 = on_dragon(get_scene("W6 E1 Dragon"), 5, nonzero)
    prof = profile_step(lambda: G.grad_scene(dscene, cfg6, target6),
                        {"b1_ms": "super_hits", "b2_ms": "_sums_kernel"})
    if prof:
        log(f"[dgrad] W6 E1 Dragon profiled step: {prof['kernels']} kernels, device busy "
            f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms trace (idle "
            f"{prof['idle']:.1%}), B1 {prof['b1_ms']:.4f} ms, B2's two kernels "
            f"{prof['b2_ms']:.4f} ms; {card}")
    else:
        log("[dgrad] the profiler recorded no device time")

    def set_diffuse(s, leaf):
        return dataclasses.replace(s, materials=dataclasses.replace(s.materials, diffuse=leaf))

    ad, fd = G.fd_check(dscene, cfg6, target6, lambda s: s.materials.diffuse, set_diffuse,
                        torch.ones_like(dscene.materials.diffuse), eps=1e-2, rtol=1e-3)
    log(f"[dgrad] W6 E1 Dragon fd_check materials.diffuse: ad {ad!r} fd {fd!r}")

    # 14b. The shadowed stand-in's step: B1, the any-hit query's kernel, B2;
    # each step's query held afterwards against the twin route on the card.
    with caught_queries() as queries:
        _, _, b1_sh, b2_sh = on_dragon(with_standin_mesh(get_scene("W5 E3 Teapot"), "dragon.obj"),
                                       2, ("geom.vertices", "camera.eye"))
    occ_sh = super_occluded.KERNEL_LAUNCHES
    if occ_sh < 3 or len(queries) != occ_sh:
        raise AssertionError(f"the shadowed steps did not each run the any-hit kernel ({occ_sh})")
    log(f"[dgrad] shadowed dragon: the any-hit kernel launched {occ_sh} times over 3 steps")
    check_queries("shadowed dragon steps", queries, super_hits.hits2)

    # 14c. One step each of W5 E5, W6 E3 and W3 E3 (textured) at their
    # registered sizes; no hand kernel but the brute-force engine's (the
    # Cornell box takes one-hot products, worksheet 3 has no mesh).
    def textured(scene):
        return dataclasses.replace(
            scene, texture=tex.TextureBuf(torch.as_tensor(seeded_texture(), device=scene.device),
                                          tex.ENV_LDR),
            uniforms=dataclasses.replace(scene.uniforms, use_texture=tex.TEX_DEFAULT,
                                         uv_scale=torch.tensor((1.5, 2.0), device=scene.device)))

    rows = (("W5 E5 Cornell Box", with_fixture_model, lambda s: s,
             ("geom.vertices", "materials.diffuse", "materials.emission", "camera.eye")),
            ("W6 E3 Cornell Box", with_fixture_model, lambda s: s,
             ("geom.vertices", "materials.diffuse", "spheres.center", "camera.eye")),
            ("W3 E3", with_textured_plane, textured,
             ("texture.data", "uniforms.uv_scale", "jitters", "tris.verts", "camera.eye")))
    for name, fix, bind, nz in rows:
        desc = fix(get_scene(name))
        scene, cfg = build_scene(desc, dev)
        scene = bind(scene)
        target = zeros(cfg)
        reset()
        out = [G.grad_scene(scene, cfg, target)]
        ms, host_ms, peak = timed_steps(lambda: out.append(G.grad_scene(scene, cfg, target)), 1)
        if any((m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) != (0, 0) for m in kernels):
            raise AssertionError(f"{name}: a hand kernel or a twin ran")
        grad_checks(name, out[-1], out[-2], nz)
        log(f"[dgrad] {name} {cfg.width}x{cfg.height}, subdivs {cfg.subdivs}, lights "
            f"{cfg.lights}: 1 step after 1: {ms:.3f} ms/step (CUDA events), {host_ms:.3f} "
            f"ms/step (host clock), peak {peak / 2**30:.3f} GiB; every leaf finite, two steps "
            f"equal bitwise, {', '.join(nz)} nonzero; {card}")

        # 14d. The same row at 32x32: the card's gradient against the CPU's.
        small = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=32, height=32))
        gs = []
        for device in (dev, "cpu"):
            sc, c = build_scene(small, device)
            gs.append(convert.grads_to_arrays(G.grad_scene(bind(sc), c, zeros(c).to(device))))
        worst = 0.0
        for k, want in gs[1].items():
            got = gs[0][k]
            scale = float(np.abs(want).max()) if want.size else 0.0
            np.testing.assert_allclose(got, want, rtol=DGRAD_CARD_RTOL, atol=1e-4 * scale,
                                       err_msg=f"{name} 32x32 card vs CPU {k}")
            if scale:
                worst = max(worst, float(np.abs(got - want).max()) / scale)
        log(f"[dgrad 32x32] {name}: the card's gradient equals the CPU's within rtol "
            f"{DGRAD_CARD_RTOL} (largest difference {worst:.3g} of a leaf's largest magnitude)")
    return dict(b1_launches=b1_w6 + b1_sh, b2_launches=b2_w6 + b2_sh, occ_launches=occ_sh)


def walk_phase(dev, card: str, kernels) -> None:
    """Phase 15: the BSP and ``bvh2`` walks (see the module docstring).
    Raises on any failed check."""
    from tracer_torch.accel import bsp, flat, lbvh, packet, traverse
    from tracer_torch.kernels import treelet_hits
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene, load_mesh
    from tracer_torch.scenes.registry import get_scene

    steps = []
    walks = (bsp.walk, traverse.walk)

    def counted(fn):
        def run(*a):
            steps.append(fn(*a))
            return steps[-1]
        return run

    def same_ids(name, ids, t, want_ids, want_t):
        differ = ids != want_ids
        n = int(differ.sum())
        far = differ & ~torch.isclose(t, want_t, rtol=1e-5, atol=0)
        log(f"[walk] {name}: ids equal the reference's on {ids.numel() - n} of {ids.numel()} "
            f"lanes; {n} differ, {int(far.sum())} of them at another t")
        if n > WALK_MAX_DIFFER * ids.numel() or bool(far.any()):
            raise AssertionError(f"{name}: hit ids differ from the reference's")

    # 15a. Project: Bunny BSP at 512x512: the BSP walk and bvh2, against
    # the treelet engine's ids (B1) on the same primary rays.
    desc = get_scene("Project: Bunny BSP")
    fscene, fcfg = build_scene(desc, dev)
    frame = (fcfg.width, fcfg.height)
    rays = integrator.primary_rays(fscene, fcfg)
    t_ref, ids_ref = flat.closest_hit(rays, fscene.tb, frame)
    for name, kw in (("BSP walk", dict(bsp_execution="walk")), ("bvh2", dict(traversal="bvh2"))):
        t0 = time.perf_counter()
        scene, cfg = build_scene(dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg,
                                                                                  **kw)), dev)
        built = time.perf_counter() - t0
        state = progressive.init_state(cfg, dev)
        for m in kernels:
            m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0
        progressive.step(scene, cfg, state)
        bsp.walk, traverse.walk = (counted(w) for w in walks)
        try:
            ms, host_ms = timed_frames(scene, cfg, state, 2)
        finally:
            bsp.walk, traverse.walk = walks
        if any((m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) != (0, 0) for m in kernels):
            raise AssertionError(f"{name}: a hand kernel or a twin ran")
        if not bool(torch.isfinite(state.accum).all()):
            raise AssertionError(f"{name}: the accumulator is not finite")
        V, I = scene.geom.vertices, scene.geom.indices
        if scene.bsp is not None:
            t, ids, conv = bsp.bsp_closest_hit(rays, scene.bsp, V, I, with_conv=True)
            if not bool(conv.all()):
                raise AssertionError(f"{name}: {int((~conv).sum())} lanes were cut")
        else:
            t, ids = traverse.bvh_closest_hit(rays, scene.bvh, V, I, max_leaf=cfg.max_leaf)
        log(f"[walk] {desc.name} {cfg.width}x{cfg.height} by the {name} (built in {built:.2f} s"
            + (f", {scene.bsp.axis.shape[0]} nodes, largest leaf {scene.bsp.max_count}"
               if scene.bsp is not None else f", {scene.bvh.left.shape[0]} nodes")
            + f"): 2 frames after 1: {ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms/frame "
            f"(host clock), {sum(steps) / 2:.0f} walk steps per frame; {card}")
        steps.clear()
        same_ids(f"{name} primary rays vs the treelet engine (B1)", ids, t, ids_ref, t_ref)

    # 15b. W9 E1's bounce-2 mesh query by the two walks, beside packet + B3.
    pdesc = get_scene("W9 E1 Bunny")
    pscene, pcfg = build_scene(pdesc, dev)
    pscene = with_seeded_env(pscene, pdesc, dev)
    caught = []
    closest = packet.closest_hit
    packet.closest_hit = lambda r, *a, **kw: caught.append(r) or closest(r, *a, **kw)
    try:
        progressive.step(pscene, pcfg, progressive.init_state(pcfg, dev))
    finally:
        packet.closest_hit = closest
    r2 = caught[1]
    pframe = (pcfg.width, pcfg.height)
    live = int((r2.tmax > r2.tmin).sum())
    mesh = load_mesh(pdesc.model, pdesc.model_scale)
    t0 = time.perf_counter()
    btree = bsp.to_device(bsp.build_for_mesh(mesh), dev)
    bvh = traverse.to_device(lbvh.build_for_mesh(mesh, max_prims=pdesc.bvh_leaf), dev)
    built = time.perf_counter() - t0
    V, I = pscene.geom.vertices, pscene.geom.indices
    treelet_hits.KERNEL_LAUNCHES = 0
    t_p, ids_p = closest(r2, pscene.tb, frame=pframe)
    if not treelet_hits.KERNEL_LAUNCHES:
        raise AssertionError("packet + B3 did not launch B3")
    packet_ms = cuda_events_ms(lambda: closest(r2, pscene.tb, frame=pframe), 3)
    bsp.walk = counted(walks[0])
    try:
        t_b, ids_b, conv = bsp.bsp_closest_hit(r2, btree, V, I, with_conv=True)
    finally:
        bsp.walk = walks[0]
    bsp_steps = steps.pop()
    bsp_ms = cuda_events_ms(lambda: bsp.bsp_closest_hit(r2, btree, V, I), 3)
    traverse.walk = counted(walks[1])
    try:
        t_v, ids_v = traverse.bvh_closest_hit(r2, bvh, V, I, max_leaf=pcfg.max_leaf)
    finally:
        traverse.walk = walks[1]
    bvh_steps = steps.pop()
    bvh_ms = cuda_events_ms(lambda: traverse.bvh_closest_hit(r2, bvh, V, I,
                                                             max_leaf=pcfg.max_leaf), 3)
    if not bool(conv.all()):
        raise AssertionError(f"the BSP walk cut {int((~conv).sum())} lanes of bounce 2")
    log(f"[walk] W9 E1 bounce 2 ({live} of {r2.tmax.numel()} lanes with a window; trees built "
        f"in {built:.2f} s): packet + B3 {packet_ms:.3f} ms, BSP walk {bsp_ms:.3f} ms "
        f"({bsp_steps} steps), bvh2 walk {bvh_ms:.3f} ms ({bvh_steps} steps) per query "
        f"(CUDA events); {card}")
    same_ids("BSP walk on W9 E1 bounce 2 vs packet + B3", ids_b, t_b, ids_p, t_p)
    same_ids("bvh2 walk on W9 E1 bounce 2 vs packet + B3", ids_v, t_v, ids_p, t_p)


def hdr_phase(dev, card: str) -> None:
    """Phase 13: ``W9 E2 Bunny`` at 64x64 with ``tests/fixtures/tiny_env.hdr.png``
    as its environment, read by the build's loader (``load_rgbe_png``):
    the card's accumulator equals the CPU's bit for bit."""
    from tracer_torch.render import progressive
    from tracer_torch.render import texture as tex
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    fixture = str(FIXTURES / "tiny_env.hdr.png")
    desc = get_scene("W9 E2 Bunny")
    desc = dataclasses.replace(desc, hdri=fixture, cfg=dataclasses.replace(
        desc.cfg, width=64, height=64))
    accs = []
    for d in (dev, "cpu"):
        scene, cfg = build_scene(desc, d)
        if scene.env is None or scene.env.kind != tex.ENV_RGBE or not torch.equal(
                scene.env.data.cpu(), tex.load_rgbe_png(fixture, "cpu").data):
            raise AssertionError("the W9 E2 build did not load the RGBE fixture")
        accs.append(progressive.render_progressive(scene, cfg, 2).accum.cpu())
    if not torch.equal(accs[0].view(torch.int32), accs[1].view(torch.int32)):
        raise AssertionError("the W9 E2 frame with the fixture environment differs on the card")
    log(f"[hdr] W9 E2 Bunny 64x64 with {FIXTURES.name}/tiny_env.hdr.png "
        f"({tuple(scene.env.data.shape)} RGBE): 2 frames, the card equals the CPU bit for bit, "
        f"{path_stats(accs[0].numpy())}; {card}")


def shard_phase(dev, card: str, kernels, dragon, ms_frame: float, ms_step: float) -> dict:
    """Phase 16: rendering and gradients over a ``torch.distributed`` group
    (see the module docstring). ``dragon`` is phase 4's (scene, cfg);
    ``ms_frame`` and ``ms_step`` phases 4's and 5's times, logged beside.
    Raises on any failed check; returns B1's, B2's and B3's launches."""
    import torch.distributed as dist

    from tracer_torch import convert
    from tracer_torch.diff import grad as G
    from tracer_torch.kernels import scatter_vn, super_hits, treelet_hits
    from tracer_torch.parallel import distributed, shard
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    scene, cfg = dragon

    def reset():
        for m in kernels:
            m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0

    def same(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    # 16a. A one-rank NCCL group: frames and gradient steps.
    single = progressive.init_state(cfg, dev)
    for _ in range(4):
        progressive.step(scene, cfg, single)
    if not distributed.initialize_from_env(dev, one_rank=True):
        raise AssertionError("no process group")
    try:
        mesh = shard.make_ray_mesh()
        if mesh.size != 1 or dist.get_backend() != "nccl":
            raise AssertionError(f"the group is {mesh.size} rank(s) on {dist.get_backend()}")
        # The same single-device frames with the group up: what the group's
        # own threads cost the host, apart from the band code.
        plain = progressive.init_state(cfg, dev)
        progressive.step(scene, cfg, plain)
        up_ms, _, _ = timed_steps(lambda: progressive.step(scene, cfg, plain), 3)
        rscene = shard.replicate_scene(scene, mesh)
        st = shard.shard_state(progressive.init_state(cfg, dev), cfg, mesh)
        step = shard.sharded_step(mesh)
        reset()
        step(rscene, cfg, st)
        ms, host_ms, _ = timed_steps(lambda: step(rscene, cfg, st), 3)
        f_b1 = super_hits.KERNEL_LAUNCHES
        if f_b1 < 4 or any(m.REFERENCE_CALLS for m in kernels):
            raise AssertionError(f"the sharded frames did not run on B1 alone ({f_b1} launches)")
        if not same(shard.gather_state(st, cfg, mesh).accum, single.accum):
            raise AssertionError("the sharded dragon frames differ from the single-device ones")
        log(f"[shard] one-rank NCCL group: {cfg.width}x{cfg.height} dragon, 3 sharded frames "
            f"after 1: {ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms/frame (host clock) "
            f"against phase 4's {ms_frame:.3f} and {up_ms:.3f} for unsharded frames with the "
            f"group up; B1 launches {f_b1} over 4 frames, twin calls 0; the gathered "
            f"accumulator equals the single-device one bit for bit; {card}")
        gcfg = dataclasses.replace(cfg, loop="scan", max_depth=2)
        target = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32, device=dev)
        want = convert.grads_to_arrays(G.grad_scene(scene, gcfg, target))
        reset()
        grads = [G.grad_scene_sharded(rscene, gcfg, target, mesh)]
        g_ms, g_host, _ = timed_steps(
            lambda: grads.append(G.grad_scene_sharded(rscene, gcfg, target, mesh)), 2)
        g_b1, g_b2 = super_hits.KERNEL_LAUNCHES, scatter_vn.KERNEL_LAUNCHES
        if min(g_b1, g_b2) < 3 or any(m.REFERENCE_CALLS for m in kernels):
            raise AssertionError("the sharded gradient steps did not run on B1 and B2 alone")
        for g in grads:
            got = convert.grads_to_arrays(g)
            for k, w in want.items():
                if not np.array_equal(got[k].view(np.int32), w.view(np.int32)):
                    raise AssertionError(f"{k}: the one-rank sharded gradient differs from "
                                         "grad_scene's")
        log(f"[shard] grad_scene_sharded: 2 steps after 1: {g_ms:.3f} ms/step (CUDA events), "
            f"{g_host:.3f} ms/step (host clock) against phase 5's {ms_step:.3f}; B1 launches "
            f"{g_b1}, B2 {g_b2} over 3 steps; every step equals grad_scene bit for bit on "
            f"every leaf; {card}")
    finally:
        dist.destroy_process_group()

    # 16b. Bands in one process, assembled: the dragon (B1) and W9 E1 at
    # 512x512 (B3 in every band).
    def bands_equal(name, sc, c, it, b3):
        full = integrator.render_sample(integrator.with_iteration(sc, it), c)
        for size in (2, 3):
            parts, per_band = [], []
            for r in range(size):
                band = shard.band_rows(c.height, r, size)
                treelet_hits.KERNEL_LAUNCHES = 0
                parts.append(integrator.render_sample(
                    integrator.with_iteration(dataclasses.replace(sc, band=band), it), c))
                per_band.append(treelet_hits.KERNEL_LAUNCHES)
            if b3 and min(per_band) < 1:
                raise AssertionError(f"{name}: a band did not run B3 ({per_band})")
            got = torch.cat(parts)
            if not same(got, full):
                differ = int((got != full).any(dim=-1).sum())
                raise AssertionError(f"{name} in {size} bands differs from the whole frame on "
                                     f"{differ} pixels")
            log(f"[shard] {name} {c.width}x{c.height} in {size} bands "
                f"({[shard.band_rows(c.height, r, size) for r in range(size)]}) equals the "
                f"whole frame bit for bit" + (f"; B3 launches per band {per_band}" if b3 else ""))
        return sum(per_band)

    bands_equal("Project: Dragon", scene, cfg, 0, False)
    pdesc = get_scene("W9 E1 Bunny")
    pscene, pcfg = build_scene(pdesc, dev)
    b3 = bands_equal("W9 E1 Bunny", with_seeded_env(pscene, pdesc, dev), pcfg, 1, True)
    return dict(b1_launches=f_b1 + g_b1, b2_launches=g_b2, b3_launches=b3)


def oracle_phase(dev, card: str) -> None:
    """Phase 17: the card's frames of ``ORACLE_CASES`` against the port's
    CPU oracle (see the module docstring). Raises on any failed check."""
    t0 = time.perf_counter()
    for name, (_, it, _, _, atol, frac) in ORACLE_CASES.items():
        img, ref = oracle_render_both(name, dev)
        need = ORACLE_JAX_SCORES.get(name, frac)
        got = oracle_score(img, ref, atol)
        log(f"[oracle] {name} {img.shape[1]}x{img.shape[0]} iteration {it}: {got:.4f} of the "
            f"pixels match the oracle (need {need:.4f}"
            + (", the JAX package's own score" if name in ORACLE_JAX_SCORES else "")
            + f"), max abs diff {float(np.abs(img - ref).max()):.4g}")
        if not np.isfinite(img).all() or img.std() <= 0.01 or got < need:
            raise AssertionError(f"{name}: the card's frame disagrees with the oracle")
    log(f"[oracle] {len(ORACLE_CASES)} cases in {time.perf_counter() - t0:.1f} s (the oracle "
        f"is scalar NumPy on the host); {card}")


JPEG_FIXTURES = ("texture_420", "texture_grey", "texture_progressive")


def jpeg_phase(dev, card: str) -> None:
    """Phase 18: the JPEG fixtures decoded on the host, and W3 E3 at
    512x512 with the 4:2:0 fixture as its texture (see the module
    docstring). Raises on any failed check."""
    from tracer_torch import io as tio
    from tracer_torch.render import jpeg, progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    jpeg.decode(str(FIXTURES / f"{JPEG_FIXTURES[0]}.jpg"))  # builds the C helper
    for name in JPEG_FIXTURES:
        path = FIXTURES / f"{name}.jpg"
        t0 = time.perf_counter()
        got = jpeg.decode(str(path))
        ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, tio.read_png(str(FIXTURES / f"{name}.pil.png"))):
            raise AssertionError(f"{name}.jpg does not decode to the stored PIL decode")
        log(f"[jpeg] {name}.jpg ({path.stat().st_size} bytes, {got.shape[1]}x{got.shape[0]}): "
            f"decoded in {ms:.3f} ms on the host, equal to PIL's decode")
    fixture = str(FIXTURES / f"{JPEG_FIXTURES[0]}.jpg")
    desc = dataclasses.replace(with_textured_plane(get_scene("W3 E3")), texture=fixture)
    accs = []
    for d in (dev, "cpu"):
        scene, cfg = build_scene(desc, d)
        if scene.texture is None or not np.array_equal(
                np.round(scene.texture.data.cpu().numpy() * 255.0), jpeg.decode(fixture)):
            raise AssertionError("the W3 E3 build did not load the JPEG fixture")
        accs.append(progressive.render_progressive(scene, cfg, 2).accum.cpu())
    if not torch.equal(accs[0].view(torch.int32), accs[1].view(torch.int32)):
        raise AssertionError("the W3 E3 frame with the JPEG texture differs on the card")
    log(f"[jpeg] W3 E3 {cfg.width}x{cfg.height} ({cfg.subdivs}x{cfg.subdivs} sub-samples) with "
        f"{JPEG_FIXTURES[0]}.jpg on its textured plane: 2 frames, the card equals the CPU bit "
        f"for bit, {path_stats(accs[0].numpy())}; {card}")


def bvh8_phase(dev, card: str, kernels) -> None:
    """Phase 19: the ``bvh8`` engine (see the module docstring). Raises on
    any failed check."""
    from tracer_torch.accel import flat, lbvh, packet, traverse, wide
    from tracer_torch.kernels import treelet_hits
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene, load_mesh
    from tracer_torch.scenes.registry import get_scene

    def same_ids(name, ids, t, want_ids, want_t):
        differ = ids != want_ids
        n = int(differ.sum())
        far = differ & ~torch.isclose(t, want_t, rtol=1e-5, atol=0)
        log(f"[bvh8] {name}: ids equal the reference's on {ids.numel() - n} of {ids.numel()} "
            f"lanes; {n} differ, {int(far.sum())} of them at another t")
        if n > WALK_MAX_DIFFER * ids.numel() or bool(far.any()):
            raise AssertionError(f"{name}: hit ids differ from the reference's")

    # 19a. Project: Bunny BSP at 512x512 by the bvh8 walk.
    desc = get_scene("Project: Bunny BSP")
    fscene, fcfg = build_scene(desc, dev)
    rays = integrator.primary_rays(fscene, fcfg)
    t_ref, ids_ref = flat.closest_hit(rays, fscene.tb, (fcfg.width, fcfg.height))
    t0 = time.perf_counter()
    scene, cfg = build_scene(dataclasses.replace(
        desc, cfg=dataclasses.replace(desc.cfg, traversal="bvh8")), dev)
    built = time.perf_counter() - t0
    if cfg.traversal != "bvh8" or scene.wide is None or scene.tb is not None:
        raise AssertionError("the bvh8 build did not make the wide BVH alone")
    state = progressive.init_state(cfg, dev)
    for m in kernels:
        m.KERNEL_LAUNCHES = m.REFERENCE_CALLS = 0
    progressive.step(scene, cfg, state)
    ms, host_ms = timed_frames(scene, cfg, state, 2)
    if any((m.KERNEL_LAUNCHES, m.REFERENCE_CALLS) != (0, 0) for m in kernels):
        raise AssertionError("bvh8: a hand kernel or a twin ran")
    if not bool(torch.isfinite(state.accum).all()):
        raise AssertionError("bvh8: the accumulator is not finite")
    t8, ids8, conv = wide.closest_hit(rays, scene.wide, with_conv=True)
    if not bool(conv.all()):
        raise AssertionError(f"bvh8: {int((~conv).sum())} primary lanes were cut")
    log(f"[bvh8] {desc.name} {cfg.width}x{cfg.height} (built in {built:.2f} s, "
        f"{scene.wide.table.shape[0]} rows, depth {scene.wide.depth}): 2 frames after 1: "
        f"{ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms/frame (host clock); {card}")
    same_ids("bvh8 primary rays vs the treelet engine (B1)", ids8, t8, ids_ref, t_ref)

    # 19b. W9 E1's bounce-2 query: packet + B3, bvh2 and bvh8.
    pdesc = get_scene("W9 E1 Bunny")
    pscene, pcfg = build_scene(pdesc, dev)
    pscene = with_seeded_env(pscene, pdesc, dev)
    caught = []
    closest = packet.closest_hit
    packet.closest_hit = lambda r, *a, **kw: caught.append(r) or closest(r, *a, **kw)
    try:
        progressive.step(pscene, pcfg, progressive.init_state(pcfg, dev))
    finally:
        packet.closest_hit = closest
    r2, pframe = caught[1], (pcfg.width, pcfg.height)
    mesh = load_mesh(pdesc.model, pdesc.model_scale)
    t0 = time.perf_counter()
    wb = wide.build(lbvh.build_for_mesh(mesh, max_prims=pdesc.bvh_leaf), mesh.vertices,
                    mesh.indices, dev)
    built = time.perf_counter() - t0
    bvh = traverse.to_device(lbvh.build_for_mesh(mesh, max_prims=pdesc.bvh_leaf), dev)
    V, I = pscene.geom.vertices, pscene.geom.indices
    treelet_hits.KERNEL_LAUNCHES = 0
    t_p, ids_p = closest(r2, pscene.tb, frame=pframe)
    if not treelet_hits.KERNEL_LAUNCHES:
        raise AssertionError("packet + B3 did not launch B3")
    t_w, ids_w, conv = wide.closest_hit(r2, wb, with_conv=True)
    if not bool(conv.all()):
        raise AssertionError(f"bvh8 cut {int((~conv).sum())} lanes of bounce 2")
    packet_ms = cuda_events_ms(lambda: closest(r2, pscene.tb, frame=pframe), 3)
    bvh2_ms = cuda_events_ms(lambda: traverse.bvh_closest_hit(r2, bvh, V, I,
                                                              max_leaf=pcfg.max_leaf), 2)
    bvh8_ms = cuda_events_ms(lambda: wide.closest_hit(r2, wb), 2)
    log(f"[bvh8] W9 E1 bounce 2 ({int((r2.tmax > r2.tmin).sum())} of {r2.tmax.numel()} lanes "
        f"with a window; wide BVH built in {built:.2f} s): packet + B3 {packet_ms:.3f} ms, "
        f"bvh2 walk {bvh2_ms:.3f} ms, bvh8 walk {bvh8_ms:.3f} ms per query (CUDA events); {card}")
    same_ids("bvh8 walk on W9 E1 bounce 2 vs packet + B3", ids_w, t_w, ids_p, t_p)


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
    t_start = time.perf_counter()
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
    from tracer_torch import convert, obs
    from tracer_torch.accel import flat, packet
    from tracer_torch.diff import grad as G
    from tracer_torch.geometry.device import refresh_tri_table
    from tracer_torch.kernels import (brute_hits, phase_a_walk, scatter_vn, super_hits,
                                      super_occluded, texel_place, treelet_hits)
    from tracer_torch.render import integrator, progressive
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    dev = tracer_torch.cuda_device()
    kernels = (super_hits, scatter_vn, treelet_hits, super_occluded)

    def reset_counts():
        for mod in kernels:
            mod.KERNEL_LAUNCHES = mod.REFERENCE_CALLS = 0
        phase_a_walk.KERNEL_LAUNCHES = 0

    # 2. Build: one nvcc per source, all started together.
    def timed_build(mod):
        t = time.perf_counter()
        return mod.build()[1], time.perf_counter() - t

    built = (*kernels, phase_a_walk, brute_hits, texel_place)
    with ThreadPoolExecutor(len(built)) as pool:
        builds = list(pool.map(timed_build, built))
    for mod, (build_log, secs) in zip(built, builds):
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
            for tq in (256, 8):
                tb_l, *rest = super_lanes(dev, any_hit, seed)
                if tq != tb_l.qblocks.shape[2]:
                    tb_l = narrow_quarters(tb_l, tq)
                max_err = max(max_err, compare(
                    f"super_lanes TQ={tq} {'any-hit' if any_hit else 'closest'} seed {seed}",
                    super_hits.hits2(tb_l, *rest, any_hit),
                    super_hits.hits2_reference(tb_l, *rest, any_hit)))
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
    log("[kernel vs twin] the any-hit query's kernel on OCCLUSION_CASES")
    for name in OCCLUSION_CASES:
        tb_o, em_o, rounds_o = occlusion_case(name, dev)
        got = super_occluded.occluded(tb_o, em_o, rounds_o)
        bad = occlusion_mismatch(em_o, got, super_occluded.occluded_reference(
            tb_o, em_o, rounds_o))
        if bad or occlusion_mismatch(em_o, got, super_occluded.occluded(tb_o, em_o, rounds_o)):
            raise AssertionError(f"any-hit query {name}: {bad} lanes differ from the twin "
                                 "route, or two launches differ")
        log(f"  any-hit query {name}: {em_o.untile(got[1]).numel()} lanes, "
            f"{int((em_o.untile(got[1]) > 0).sum())} blocked, "
            f"{int(em_o.overflow.sum())} of {em_o.n_super} super-tiles overflowing, converged "
            f"{bool(got[2].all())}; flags, t and converged equal the twin route's bitwise")
        check_sweep_gates(f"any-hit query {name}", tb_o, em_o, rounds_o)

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
    fprof = profile_step(lambda: progressive.step(scene, cfg, state),
                         {"b1_ms": "super_hits_kernel"})
    if fprof:
        log(f"[main] profiled frame: {fprof['kernels']} kernels, device busy "
            f"{fprof['busy_ms']:.3f} ms of a {fprof['span_ms']:.3f} ms trace (idle "
            f"{fprof['idle']:.1%}), B1 {fprof['b1_ms']:.4f} ms "
            f"({fprof['b1_ms'] / fprof['busy_ms']:.1%} of busy); {card}")
    else:
        log("[main] the profiler recorded no device time")

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

    # 6a. Main path: 1 warm-up + 10 timed frames, every one through B3, and
    # every walk iteration of the timed ones in phase A's walk kernel.
    reset_counts()
    per_frame = []
    progressive.step(pscene, pcfg, pstate)
    torch.cuda.synchronize()
    per_frame.append(treelet_hits.KERNEL_LAUNCHES)
    frames = 10
    walk_names = ("packet.phase_a_iterations", "packet.phase_a_kernel_iterations")
    walk_counts = [[obs.counters().get(k, 0) for k in walk_names] + [phase_a_walk.KERNEL_LAUNCHES]]
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        progressive.step(pscene, pcfg, pstate)
        per_frame.append(treelet_hits.KERNEL_LAUNCHES)
        walk_counts.append([obs.counters().get(k, 0) for k in walk_names]
                           + [phase_a_walk.KERNEL_LAUNCHES])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p_launches, p_ref = treelet_hits.KERNEL_LAUNCHES, treelet_hits.REFERENCE_CALLS
    if super_hits.KERNEL_LAUNCHES or scatter_vn.KERNEL_LAUNCHES:
        raise AssertionError("the path frame ran a direct-mode or gradient kernel")
    if min(np.diff([0] + per_frame)) < 1 or p_ref != 0:
        raise AssertionError(f"a path frame did not run on B3 alone (launches {per_frame}, "
                             f"twin calls {p_ref})")
    walk_iters, walk_kernel_iters, walk_frame_launches = np.diff(walk_counts, axis=0).T.tolist()
    if min(walk_frame_launches) < 1 or walk_kernel_iters != walk_iters \
            or [n * packet.CHECK_EVERY for n in walk_frame_launches] != walk_iters:
        raise AssertionError(f"a path frame's walk did not run in phase A's walk kernel, one "
                             f"launch a batch (launches {walk_frame_launches}, iterations "
                             f"{walk_iters}, in the kernel {walk_kernel_iters})")
    p_ms = start.elapsed_time(end) / frames
    log(f"[path] {frames} frames: {p_ms:.3f} ms/frame (CUDA events), "
        f"{wall / frames * 1e3:.3f} ms/frame (host clock), primary "
        f"{pcfg.width * pcfg.height / (p_ms * 1e3):.3f} Mpath/s; {card}")
    log(f"[path] B3 launches {p_launches} over {frames + 1} frames (cumulative {per_frame}), "
        f"twin calls {p_ref}")
    log(f"[path] phase A walk kernel over the {frames} timed frames: launches "
        f"{walk_frame_launches}, walk iterations {walk_iters}, of them in the kernel "
        f"{walk_kernel_iters}")

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

    # 6d. Packet phase A's walk kernel against _body over the first round
    # of the frame's first-bounce chunk.
    walk_wk, walk_saved = first_bounce_walk(pscene, pcfg)
    walk_launches, walk_work = check_walk_kernel(walk_wk, walk_saved)
    log(f"[kernel vs twin] phase A walk W9 E1 first bounce: {walk_wk.o.shape[0]} tiles, "
        f"{walk_launches} launches of {packet.CHECK_EVERY} iterations to the first round's "
        f"end, in the first {walk_work}; every buffer equal to _body's bitwise")

    # 6e. The same frame under the profiler.
    prof = profile_step(lambda: progressive.step(pscene, pcfg, pstate),
                        {"b3_ms": "treelet_hits_kernel"})
    if prof:
        log(f"[path] profiled frame: {prof['kernels']} kernels, device busy "
            f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms trace (idle "
            f"{prof['idle']:.1%}), B3 {prof['b3_ms']:.3f} ms; {card}")
    else:
        log("[path] the profiler recorded no device time")

    # 6f. A 32x32 frame against the JAX package's numbers.
    sdesc = dataclasses.replace(pdesc, cfg=dataclasses.replace(pdesc.cfg, width=32, height=32))
    sscene, scfg = build_scene(sdesc, dev)
    sst = progressive.render_progressive(with_seeded_env(sscene, sdesc, dev), scfg, 2)
    stats = path_stats(sst.accum.cpu().numpy())
    log(f"[path 32x32] {stats} (JAX: {PATH_REF})")
    bad = path_errors(stats)
    if bad:
        raise AssertionError("the 32x32 path frame disagrees with the JAX package: " + "; ".join(bad))

    # 6g. W9 E2 Bunny (the holdout plane's occlusion probe): 1 + 3 frames.
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
    TQ = scene.tb.qblocks.shape[2]
    b1_all_ms, b1_all_by = b1_bound(args, b1_stats["visits"] * 128 * TQ)
    b1_bound_ms, b1_by = b1_bound(args, b1_stats["live_tests"])
    em0 = em_closest
    args0 = frame_args(em0, scene.tb)
    kernel0_ms = cuda_events_ms(lambda: super_hits.hits2(*args0, False), 50)
    plain0_ms = cuda_events_ms(lambda: super_hits.hits2_reference(*args0, False), 2)
    log(f"[time] hits2 seeded frame: kernel {kernel_ms:.4f} ms, twin {plain_ms:.2f} ms, "
        f"bound over live tests {b1_bound_ms:.4f} ms ({b1_by}; {b1_stats['live_tests']} tests), "
        f"bound over all lanes {b1_all_ms:.4f} ms ({b1_all_by}; {b1_stats['visits']} sub-tile x "
        f"quarter visits x 128 x {TQ}); unseeded frame: kernel {kernel0_ms:.4f} ms, twin "
        f"{plain0_ms:.2f} ms; {card}")
    sup_r, sup_v = b1_stats["super_rounds"].cpu(), b1_stats["super_visits"].cpu()
    log(f"[time] B1's work on the seeded frame (its twin's counts): {em.n_super} super-tiles, "
        f"{b1_stats['staged']} staged slots, {b1_stats['rounds']} rounds, "
        f"{b1_stats['visits']} visits ({b1_stats['visits'] * 128 * TQ} tests over all lanes, "
        f"{b1_stats['live_tests']} of live lanes, "
        f"{b1_stats['live_tests'] / (kernel_ms * 1e9):.3f} T live Moller tests/s); per "
        f"super-tile rounds max {int(sup_r.max())} median {int(sup_r.median())}, "
        f"visits max {int(sup_v.max())}")
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
    tp = texel_times(dev, card)
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

    walk_ms, walk_plain_ms = time_walk(walk_wk, walk_saved)
    walk_bound_ms, walk_by = walk_bound(walk_wk, walk_work)
    log(f"[time] phase A walk W9 E1 first-bounce chunk ({walk_wk.o.shape[0]} tiles, "
        f"{packet.CHECK_EVERY} iterations from the root): kernel {walk_ms:.4f} ms per launch, "
        f"_body eager {walk_plain_ms:.3f} ms, "
        f"bound {walk_bound_ms:.4f} ms ({walk_by}; {walk_work}); {card}")

    # 8. Path mode in the Cornell box (the brute-force engine and its kernel).
    cb = cornell_phase(dev, card, kernels)

    # 9. Path-mode gradients: W8 E3 (the brute-force kernel) and W9 E1 (B3 and B2).
    pg = pgrad_phase(dev, card, kernels)
    b2_err = max(b2_err, pg["b2_err"])

    # 10. Direct mode: the dragon rows through B1 (closest and any-hit), the
    # Cornell rows (the brute-force kernel) and worksheets 1-3 (no hand kernel).
    dr = direct_phase(dev, card, kernels, (scene, cfg, desc, rays, ids_k))
    max_err = max(max_err, dr["b1_err"])

    # 11. The sun: W9 E3 on the bunny stand-in through B3 (closest and any-hit).
    sun = sun_phase(dev, card, kernels)
    b3_err = max(b3_err, sun["b3_err"])

    # 12. The CLI on the dragon (B1), checkpoint and resume, the REPL.
    cl = cli_phase(dev, card, kernels)

    # 13. The RGBE loader on W9 E2.
    hdr_phase(dev, card)

    # 14. Direct-mode gradients: W6 E1 Dragon and the shadowed stand-in
    # (B1 and B2), the Cornell rows (the brute-force kernel) and worksheet 3.
    t0 = time.perf_counter()
    dg = dgrad_phase(dev, card, kernels, (scene, cfg, desc, rays, ids_k))
    t1 = time.perf_counter()

    # 15. The BSP and bvh2 walks (PyTorch ops; no hand kernel).
    walk_phase(dev, card, kernels)
    t2 = time.perf_counter()

    # 16. Rendering and gradients over a process group, and in bands.
    sh = shard_phase(dev, card, kernels, (scene, cfg), ms_frame, ms_step)
    t3 = time.perf_counter()

    # 17. The card's frames against the port's CPU oracle.
    oracle_phase(dev, card)
    t4 = time.perf_counter()

    # 18. The JPEG decoder, and a textured frame from a JPEG.
    jpeg_phase(dev, card)
    t5 = time.perf_counter()

    # 19. The bvh8 walk (PyTorch ops; no hand kernel).
    bvh8_phase(dev, card, kernels)
    t6 = time.perf_counter()
    log(f"[time] phase 14 took {t1 - t0:.1f} s, 15 {t2 - t1:.1f} s, 16 {t3 - t2:.1f} s, "
        f"17 {t4 - t3:.1f} s, 18 {t5 - t4:.1f} s, 19 {t6 - t5:.1f} s; the smoke "
        f"{t6 - t_start:.1f} s in all (host clock)")

    log(json.dumps({"kernels": [{
        "name": "super_hits.hits2",
        "route": "cuda",
        "source": "tracer_torch/csrc/super_hits.cu",
        "replaces": "tracer/kernels/super_hits.py:262",
        "launches": launches + g_launches["super_hits"] + dr["b1_launches"]
        + cl["b1_launches"] + dg["b1_launches"] + sh["b1_launches"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b1_bound_ms,
        "bound_by": b1_by,
        "bound_all_lanes_ms": b1_all_ms,
        "library_ms": None,
    }, {
        "name": "scatter_vn.segment_place",
        "route": "cuda",
        "source": "tracer_torch/csrc/scatter_vn.cu",
        "replaces": "tracer/kernels/scatter_vn.py:109",
        "launches": g_launches["scatter_vn"] + pg["b2_launches"] + dg["b2_launches"]
        + sh["b2_launches"],
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "device_ms": b2_device_ms,
        "plain_ms": b2_plain_ms,
        "bound_ms": b2_bound_ms,
        "bound_by": b2_by,
        "library_ms": b2_lib_ms,
    }, {
        "name": "texel_place.place",
        "route": "cuda",
        "source": "tracer_torch/csrc/texel_place.cu",
        "replaces": "none (the gathers' backward is XLA's in the JAX package, "
                    "tracer/render/texture.py)",
        "launches": pg["texel_launches"],
        "max_abs_err": 0.0,
        **{k: tp[k] for k in ("ms", "device_ms", "plain_ms", "backward_ms", "bound_ms",
                              "bound_by", "library_ms")},
    }, {
        "name": "treelet_hits.hits",
        "route": "cuda",
        "source": "tracer_torch/csrc/treelet_hits.cu",
        "replaces": "tracer/kernels/treelet_hits.py:160",
        "launches": p_launches + e_launches + pg["b3_launches"] + sun["b3_launches"]
        + sh["b3_launches"],
        "max_abs_err": b3_err,
        "ms": b3_ms,
        "plain_ms": b3_plain_ms,
        "bound_ms": b3_bound_ms,
        "bound_by": b3_by,
        "bound_all_lanes_ms": b3_all_ms,
        "library_ms": None,
    }, {
        "name": "phase_a_walk.walk",
        "route": "cuda",
        "source": "tracer_torch/csrc/phase_a_walk.cu",
        "replaces": "none (phase A is XLA in the JAX package, tracer/accel/packet.py)",
        "launches": sum(walk_frame_launches),
        "main_path_frames": frames,
        "launches_per_frame": walk_frame_launches,
        "iterations_per_frame": walk_iters,
        "kernel_iterations_per_frame": walk_kernel_iters,
        "max_abs_err": 0.0,
        "ms": walk_ms,
        "plain_ms": walk_plain_ms,
        "bound_ms": walk_bound_ms,
        "bound_by": walk_by,
        "library_ms": None,
    }, {
        "name": "super_occluded.occluded",
        "route": "cuda",
        "source": "tracer_torch/csrc/super_occluded.cu",
        "replaces": "tracer/kernels/super_hits.py:262 (any-hit), with tracer/accel/flat.py:573",
        "launches": dr["occ_launches"] + dg["occ_launches"],
        "max_abs_err": dr["occ_bad"],
        "ms": dr["occ_ms"],
        "old_route_ms": dr["occ_old_ms"],
        "plain_ms": dr["occ_plain_ms"],
        "bound_ms": dr["occ_bound_ms"],
        "bound_by": dr["occ_by"],
        "bound_twin_route_ms": dr["occ_twin_bound_ms"],
        "list_only_ms": dr["occ_list_ms"],
        "b1_list_only_ms": dr["occ_b1_list_ms"],
        "live_tests": dr["occ_live_tests"],
        "sweep_pairs_open": dr["occ_open_pairs"],
        "sweep_pairs": dr["occ_sweep_pairs"],
        "library_ms": None,
    }, {
        "name": "brute_hits.closest / brute_hits.any_hit",
        "route": "cuda",
        "source": "tracer_torch/csrc/brute_hits.cu",
        "replaces": "none (mesh_brute_force is XLA in the JAX package, "
                    "tracer/kernels/intersect.py)",
        "launches": cb["launches"],
        "max_abs_err": 0.0,
        **{f"{key}_{k}": v for key, t in cb["times"].items() for k, v in t.items()},
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

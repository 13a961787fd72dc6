"""Rendering and gradients over several ranks (``tracer_torch.parallel``,
``grad_scene_sharded``), on the CPU with gloo.

Each world size (2 and 3 ranks) is one group of child processes (``python
tests/test_torch_shard.py worker RANK WORLD STORE OUT``; a file store under
``tmp_path``, a group timeout, every child joined with a timeout and
required to exit 0). In them:

* ``W8 E3 Absorption`` at 24x20 (the Cornell fixture, brute force; one
  band, so the other ranks hold empty bands) and ``Project: Bunny`` at
  64x48 (the flat engine through B1's twin; 2 bands of 32 and 16 rows, so
  with 3 ranks one is empty), 2 progressive frames by
  ``render_progressive_sharded``, gathered: bitwise equal to the
  single-device frames of ``progressive.render_progressive``;
* ``grad_scene_sharded`` on ``Project: Bunny`` at 64x48 (direct mode,
  ``scan``, B1's and B2's twins) and ``W8 E3`` at 24x40 (path mode), twice:
  the two runs bitwise equal on every leaf, and each leaf allclose to the
  single-device ``grad_scene`` at rtol 1e-5 plus 1e-6 of the leaf's
  largest magnitude (the bands' partial sums add in another order);
* the same two frames against the JAX package's
  ``tracer.parallel.shard.render_progressive_sharded`` on its 8-device CPU
  mesh (a child process), at ``tests/test_torch_cornell.py``'s tolerance
  (rtol 1e-4 / atol 1e-5 on at least 99% of the pixels);
* one rank: ``grad_scene_sharded`` bitwise equal to ``grad_scene``;
* the CLI: ``--sharded --device cpu`` with one rank in process and with two
  ranks under ``torchrun``'s variables (two child processes, a rendezvous on
  127.0.0.1), each ``--out-npz`` bitwise equal to the unsharded run's, and a
  sharded checkpoint resumed to the same image.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
from _share_cores import share_cores

from chip_smoke import path_stats, with_fixture_model

from tracer_torch import cli, convert
from tracer_torch.diff import grad as G
from tracer_torch.render import progressive
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

REPO = Path(__file__).resolve().parents[1]
FRAMES = ("W8 E3 Absorption", "Project: Bunny")
SIZES = {"W8 E3 Absorption": (24, 20), "Project: Bunny": (64, 48)}
GRADS = {"Project: Bunny": (64, 48), "W8 E3 Absorption": (24, 40)}
CHILD_TIMEOUT = 600


def _desc(get, name, size):
    d = get(name)
    d = dataclasses.replace(d, cfg=dataclasses.replace(d.cfg, width=size[0], height=size[1]))
    return with_fixture_model(d) if "Cornell" in (d.model or "") else d


def _grad_cfg(cfg):
    return dataclasses.replace(cfg, loop="scan", max_depth=2)


def _target(cfg):
    return torch.zeros((cfg.width * cfg.height, 3))


def _worker(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from tracer_torch.parallel import shard

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    mesh = shard.make_ray_mesh()
    res = {"frames": {}, "grads": {}}
    for name in FRAMES:
        scene, cfg = build_scene(_desc(get_scene, name, SIZES[name]), "cpu")
        st = shard.render_progressive_sharded(scene, cfg, 2, mesh)
        res["frames"][name] = shard.gather_state(st, cfg, mesh).accum.numpy()
    for name, size in GRADS.items():
        scene, cfg = build_scene(_desc(get_scene, name, size), "cpu")
        scene = shard.replicate_scene(scene, mesh)
        res["grads"][name] = [
            convert.grads_to_arrays(G.grad_scene_sharded(scene, _grad_cfg(cfg), _target(cfg),
                                                         mesh)) for _ in range(2)]
    dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def _write_jax_side(out: Path) -> None:
    import jax

    from tracer.parallel import shard as jax_shard
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8
    side = {}
    for name in FRAMES:
        scene, cfg = jax_build_scene(_desc(jax_get_scene, name, SIZES[name]))
        st = jax_shard.render_progressive_sharded(scene, cfg, 2)
        side[name] = np.asarray(st.accum)[:cfg.width * cfg.height]
    with open(out, "wb") as f:
        pickle.dump(side, f)


def _env():
    path = os.pathsep.join(filter(None, [str(REPO), str(REPO / "tests"),
                                         os.environ.get("PYTHONPATH")]))
    return {**os.environ, "PYTHONPATH": path, "TRACER_NO_SCENE_CACHE": "1"}


def _join(procs):
    """Wait for every child; kill all and fail if one fails or hangs."""
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a rank did not finish in time")
    for p, (_, err) in zip(procs, outs):
        if p.returncode:
            pytest.fail(f"a rank exited {p.returncode}:\n{err[-4000:]}")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [each rank's results]}, both groups run at once."""
    tmp = tmp_path_factory.mktemp("shard")
    procs = []
    for world in (2, 3):
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "worker", str(rank), str(world),
                 str(tmp / f"store{world}"), str(tmp / f"out{world}")],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    _join(procs)
    out = {}
    for world in (2, 3):
        out[world] = []
        for rank in range(world):
            with open(tmp / f"out{world}.{rank}", "rb") as f:
                out[world].append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_shard") / "side.pkl"
    env = {**_env(), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    run = subprocess.run([sys.executable, __file__, "jax", str(out)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    if run.returncode:
        pytest.fail(f"the JAX side failed:\n{run.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


def _single_frame(name):
    scene, cfg = build_scene(_desc(get_scene, name, SIZES[name]), "cpu")
    return progressive.render_progressive(scene, cfg, 2).accum.numpy()


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", FRAMES)
def test_sharded_frame_equals_single_device(ranks, name, world):
    want = _single_frame(name)
    assert float(np.abs(want).sum()) > 0
    for res in ranks[world]:
        got = res["frames"][name]
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", FRAMES)
def test_sharded_frame_against_jax_mesh(jax_side, name):
    got, want = _single_frame(name), jax_side[name]
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} pixels differ"
    assert path_stats(want)["sum"] != 0


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", list(GRADS))
def test_sharded_gradient(ranks, name, world):
    scene, cfg = build_scene(_desc(get_scene, name, GRADS[name]), "cpu")
    want = convert.grads_to_arrays(G.grad_scene(scene, _grad_cfg(cfg), _target(cfg)))
    first = ranks[world][0]["grads"][name][0]
    assert float(np.abs(want["camera.eye"]).sum()) > 0
    for res in ranks[world]:
        a, b = res["grads"][name]
        for k, w in want.items():
            assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k
            assert np.array_equal(a[k].view(np.uint32), first[k].view(np.uint32)), k
            np.testing.assert_allclose(a[k], w, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(w).max(initial=0.0)), err_msg=k)


def _one_rank_group():
    import torch.distributed as dist

    from tracer_torch.parallel import distributed, shard

    assert not dist.is_initialized()
    assert distributed.initialize_from_env("cpu", one_rank=True)
    return shard.make_ray_mesh()


def test_one_rank_gradient_is_grad_scene():
    import torch.distributed as dist

    scene, cfg = build_scene(_desc(get_scene, "Project: Bunny", GRADS["Project: Bunny"]), "cpu")
    want = convert.grads_to_arrays(G.grad_scene(scene, _grad_cfg(cfg), _target(cfg)))
    mesh = _one_rank_group()
    try:
        got = convert.grads_to_arrays(
            G.grad_scene_sharded(scene, _grad_cfg(cfg), _target(cfg), mesh))
    finally:
        dist.destroy_process_group()
    assert mesh.size == 1 and want.keys() == got.keys()
    for k in want:
        assert np.array_equal(got[k].view(np.uint32), want[k].view(np.uint32)), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_sharded_equals_unsharded(tmp_path):
    base = ["--device", "cpu", "--scene", "Project: Bunny", "--width", "64", "--height", "48",
            "--samples", "2", "--stats-every", "0"]
    assert cli.main(base + ["--out-npz", str(tmp_path / "plain.npz")]) == 0
    assert cli.main(base + ["--sharded", "--out-npz", str(tmp_path / "one.npz")]) == 0
    ck = str(tmp_path / "ck.npz")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tracer_torch.cli", *base, "--sharded", *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**_env(), "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "OMP_NUM_THREADS": "1"})
        for rank, extra in ((0, ["--out-npz", str(tmp_path / "two.npz")]), (1, []))]
    _join(procs)
    half = base[:-3] + ["1", "--stats-every", "0"]
    assert cli.main(half + ["--sharded", "--checkpoint", ck]) == 0
    assert cli.main(base + ["--sharded", "--checkpoint", ck, "--resume",
                            "--out-npz", str(tmp_path / "resumed.npz")]) == 0
    with np.load(tmp_path / "plain.npz") as p:
        want = p["image"].view(np.uint32)
        assert int(p["iteration"]) == 2 and want.shape == (48, 64, 3)
    for name in ("one", "two", "resumed"):
        with np.load(tmp_path / f"{name}.npz") as z:
            assert int(z["iteration"]) == 2, name
            assert np.array_equal(z["image"].view(np.uint32), want), name


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        _write_jax_side(Path(sys.argv[2]))

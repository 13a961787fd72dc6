"""The port's CLI (``python -m tracer_torch.cli``) against the JAX
package's (``python -m tracer.cli``).

* ``--device cpu --scene "W1 E6" --width 16 --height 16 --samples 2
  --out-npz``: the image matches the JAX CLI's (run with
  ``JAX_PLATFORMS=cpu``) at ``chip_smoke.DIRECT_RTOL``, and the iteration
  count is equal. Both run in child processes: in this JAX version a
  jitted render in a process breaks a later one (ROADMAP §C).
* ``--list`` prints the JAX package's text.
* ``--interactive`` over a pipe: the image saved after ``c``, ``m1`` and
  ``r`` is the one the same flags give in one run, bit for bit.
* ``--checkpoint`` then ``--resume`` equals a straight run bit for bit
  (``W9 E1 Bunny`` at 8x8, path mode); ``--profile`` writes a trace.
* The REPL's other commands (``uv 2 2``, ``tex 2``, ``move wwa``,
  ``reset``, ``m2 3``, ``r 1``, ``save``) through both CLIs on ``W3 E2`` at
  16x16: the saved PNGs decode to the same bytes.
* The flags the port refused before run on the CPU: ``--sharded`` (one
  rank) equals the unsharded image bit for bit, ``--traversal bvh8``
  (alone and sharded) equals the treelet engine's frame at atol 1e-5 on at
  least 99.5% of the pixels; without a card and without ``--device cpu``
  the CLI stops with one sentence.
* ``--traversal bvh2`` runs: the bunny's frame through the ``bvh2`` walk
  equals the treelet engine's at atol 1e-5 on at least 99.5% of the
  pixels.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _share_cores import share_cores

from chip_smoke import DIRECT_RTOL
from tracer import cli as jax_cli

from tracer_torch import cli, io
from tracer_torch.scenes import build

share_cores()

REPO = Path(__file__).resolve().parents[1]


def _run(module: str, *args, stdin: str | None = None) -> subprocess.CompletedProcess:
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    run = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, capture_output=True,
                         text=True, input=stdin,
                         env={**os.environ, "PYTHONPATH": path, "JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, f"{module} {args} failed:\n{run.stderr[-4000:]}"
    return run


def test_out_npz_matches_jax_cli(tmp_path):
    args = ("--scene", "W1 E6", "--width", "16", "--height", "16", "--samples", "2")
    _run("tracer_torch.cli", "--device", "cpu", *args, "--out-npz", str(tmp_path / "p.npz"))
    _run("tracer.cli", *args, "--out-npz", str(tmp_path / "j.npz"))
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files) == ["image", "iteration"]
        assert int(p["iteration"]) == int(j["iteration"]) == 2
        assert p["image"].shape == j["image"].shape == (16, 16, 3)
        np.testing.assert_allclose(p["image"], j["image"], rtol=DIRECT_RTOL, atol=0)
        assert float(np.abs(j["image"]).sum()) > 0


def test_list_matches_jax(capsys):
    assert cli.main(["--list"]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["--list"]) == 0
    assert ours == capsys.readouterr().out and len(ours.splitlines()) == 44


def test_interactive_over_stdin(tmp_path):
    size = ("--scene", "W1 E6", "--width", "12", "--height", "10", "--samples", "1")
    run = _run("tracer_torch.cli", "--device", "cpu", *size, "--interactive",
               "--out", str(tmp_path / "quit.png"),
               stdin=f"c 2.0\nm1 5\nbogus\nr 2\nsave {tmp_path / 'repl.png'}\nq\n")
    assert "unknown command: bogus" in run.stderr and "iteration=3" in run.stderr
    assert cli.main(["--device", "cpu", *size[:-1], "3", "--camera-constant", "2.0",
                     "--sphere-material", "5", "--out", str(tmp_path / "flags.png")]) == 0
    repl = (tmp_path / "repl.png").read_bytes()
    assert repl == (tmp_path / "flags.png").read_bytes() == (tmp_path / "quit.png").read_bytes()
    assert io.read_png(str(tmp_path / "repl.png")).shape == (10, 12, 4)


def test_checkpoint_resume_and_profile(tmp_path):
    size = ["--device", "cpu", "--scene", "W9 E1 Bunny", "--width", "8", "--height", "8",
            "--stats-every", "0", "--camera-moves", "wad", "--texture-mode", "1",
            "--uv-scale", "2", "2"]
    ck = str(tmp_path / "ck.npz")
    assert cli.main(size + ["--samples", "3", "--out-npz", str(tmp_path / "straight.npz")]) == 0
    assert cli.main(size + ["--samples", "2", "--checkpoint", ck, "--checkpoint-every", "1"]) == 0
    assert cli.main(size + ["--samples", "3", "--checkpoint", ck, "--resume",
                            "--out-npz", str(tmp_path / "resumed.npz"),
                            "--out-pfm", str(tmp_path / "r.pfm"),
                            "--profile", str(tmp_path / "prof")]) == 0
    with np.load(tmp_path / "straight.npz") as a, np.load(tmp_path / "resumed.npz") as b:
        assert int(a["iteration"]) == int(b["iteration"]) == 3
        assert np.array_equal(a["image"].view(np.uint32), b["image"].view(np.uint32))
        assert np.array_equal(io.read_pfm(str(tmp_path / "r.pfm")), b["image"])
    with np.load(ck) as z:
        assert int(z["iteration"]) == 3
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flags", [["--sharded"], ["--traversal", "bvh8"],
                                   ["--traversal", "bvh8", "--sharded"]],
                         ids=["sharded", "bvh8 cpu", "bvh8"])
def test_formerly_refused_flags_run(flags, tmp_path):
    size = ["--device", "cpu", "--scene", "Project: Bunny", "--width", "16", "--height", "12",
            "--samples", "2", "--stats-every", "0"]
    assert cli.main(size + flags + ["--out-npz", str(tmp_path / "f.npz")]) == 0
    assert cli.main(size + ["--out-npz", str(tmp_path / "t.npz")]) == 0
    with np.load(tmp_path / "f.npz") as f, np.load(tmp_path / "t.npz") as t:
        assert int(f["iteration"]) == int(t["iteration"]) == 2 and np.abs(t["image"]).sum() > 0
        if "bvh8" in flags:
            close = np.isclose(f["image"], t["image"], rtol=0, atol=1e-5).all(axis=-1)
            assert close.mean() >= 0.995
        else:
            assert np.array_equal(f["image"].view(np.uint32), t["image"].view(np.uint32))


def test_repl_commands_match_jax_cli(tmp_path):
    args = ("--scene", "W3 E2", "--width", "16", "--height", "16", "--samples", "1",
            "--interactive")
    cmds = "uv 2 2\ntex 2\nmove wwa\nreset\nm2 3\nr 1\nsave {}\nq\n"
    p_run = _run("tracer_torch.cli", "--device", "cpu", *args,
                 stdin=cmds.format(tmp_path / "p.png"))
    _run("tracer.cli", *args, stdin=cmds.format(tmp_path / "j.png"))
    assert "accumulator cleared" in p_run.stderr and "iteration=1" in p_run.stderr
    p, j = io.read_png(str(tmp_path / "p.png")), io.read_png(str(tmp_path / "j.png"))
    assert p.shape == j.shape == (16, 16, 4)
    assert np.array_equal(p, j) and (p[..., :3] > 0).any()


def test_default_device_is_the_card(monkeypatch, capsys):
    def no_work(*a, **k):
        raise AssertionError("the CLI built a scene")

    monkeypatch.setattr(build, "build_scene", no_work)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--scene", "W1 E6"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0] and "--device cpu" in err[0]


def test_traversal_bvh2_runs(tmp_path):
    size = ["--device", "cpu", "--scene", "Project: Bunny", "--width", "16", "--height", "12"]
    assert cli.main(size + ["--traversal", "bvh2", "--out-npz", str(tmp_path / "b.npz")]) == 0
    assert cli.main(size + ["--out-npz", str(tmp_path / "t.npz")]) == 0
    with np.load(tmp_path / "b.npz") as b, np.load(tmp_path / "t.npz") as t:
        close = np.isclose(b["image"], t["image"], rtol=0, atol=1e-5).all(axis=-1)
        assert close.mean() >= 0.995 and np.abs(t["image"]).sum() > 0

"""Checkpoint and resume, image export and render statistics of the port
against the JAX package's.

* ``render_progressive`` with a checkpoint every 2 frames, stopped after 3
  and resumed from the file to 5, on ``W8 E3 Absorption`` at 12x12 (the
  Cornell box of ``chip_smoke.with_fixture_model``): the accumulator, the
  seed and the frame counter bit for bit equal to an uninterrupted run.
* Checkpoints cross between the packages in both directions (the JAX
  package's ``.npz`` layout), with the arrays equal to the file's; a file
  without ``seed_t`` loads with a zero seed; another resolution raises.
* ``write_pfm`` writes the JAX package's bytes; ``read_pfm`` reads them
  back. ``write_png`` decodes (PIL, test side, and the port's
  ``read_png``) to the pixels of ``tracer.io.write_png``'s file.
  ``write_npz`` stores the JAX package's arrays.
* ``RenderStats.summary`` prints the JAX package's text for the same frame
  times.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores
from PIL import Image

from chip_smoke import with_fixture_model
from tracer import io as jax_io
from tracer import tools as jax_tools
from tracer.render import progressive as jax_progressive
from tracer.render.scene import SceneConfig as JaxSceneConfig

from tracer_torch import io, tools
from tracer_torch.render import progressive
from tracer_torch.render.scene import SceneConfig
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()


def _bits(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32)


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    desc = with_fixture_model(get_scene("W8 E3 Absorption"))
    desc = dataclasses.replace(desc, cfg=dataclasses.replace(desc.cfg, width=12, height=12))
    scene, cfg = build_scene(desc, "cpu")
    straight = progressive.render_progressive(scene, cfg, 5)
    ck = str(tmp_path / "w8e3.npz")
    first = progressive.render_progressive(scene, cfg, 3, checkpoint_path=ck, checkpoint_every=2)
    assert first.iteration == 3
    resumed = progressive.load_checkpoint(ck, cfg, "cpu")
    assert resumed.iteration == 2  # the checkpoint of frame 2; frame 3 is redone
    resumed = progressive.render_progressive(scene, cfg, 5, state=resumed)
    assert resumed.iteration == straight.iteration == 5
    assert np.array_equal(_bits(resumed.accum), _bits(straight.accum))
    assert np.array_equal(_bits(resumed.seed_t), _bits(straight.seed_t))
    assert float(straight.accum.sum()) > 0
    assert not list(tmp_path.glob("*.tmp*"))


def _seeded_state(n: int, seed: int):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 3).astype(np.float32), np.uint32(rs.randint(1, 1000)),
            rs.rand(n).astype(np.float32))


def test_checkpoints_cross_between_packages(tmp_path):
    w, h = 6, 4
    jcfg = JaxSceneConfig(width=w, height=h, name="cross")
    cfg = SceneConfig(width=w, height=h, name="cross")
    accum, it, seed = _seeded_state(w * h, 0)
    jpath = str(tmp_path / "from_jax.npz")
    jax_progressive.save_checkpoint(jpath, jax_progressive.ProgressiveState(
        accum=jnp.asarray(accum), iteration=jnp.asarray(it), seed_t=jnp.asarray(seed)), jcfg)
    got = progressive.load_checkpoint(jpath, cfg, "cpu")
    assert got.iteration == int(it)
    assert np.array_equal(_bits(got.accum), _bits(accum))
    assert np.array_equal(_bits(got.seed_t), _bits(seed))

    accum, it, seed = _seeded_state(w * h, 1)
    ppath = str(tmp_path / "from_port.npz")
    progressive.save_checkpoint(ppath, progressive.ProgressiveState(
        accum=torch.as_tensor(accum), iteration=int(it), seed_t=torch.as_tensor(seed)), cfg)
    back = jax_progressive.load_checkpoint(ppath, jcfg)
    assert int(back.iteration) == int(it) and back.iteration.dtype == jnp.uint32
    assert np.array_equal(_bits(back.accum), _bits(accum))
    assert np.array_equal(_bits(back.seed_t), _bits(seed))
    with np.load(ppath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_checkpoint_without_seed_and_wrong_size(tmp_path):
    w, h = 5, 3
    cfg = SceneConfig(width=w, height=h)
    accum, it, _ = _seeded_state(w * h, 2)
    path = str(tmp_path / "old.npz")
    np.savez(path, accum=accum, iteration=it, width=w, height=h, name="old")
    st = progressive.load_checkpoint(path, cfg, "cpu")
    assert st.iteration == int(it) and not st.seed_t.any() and st.seed_t.shape == (w * h,)
    assert np.array_equal(_bits(st.accum), _bits(accum))
    with pytest.raises(ValueError, match="resolution"):
        progressive.load_checkpoint(path, SceneConfig(width=w, height=h + 1), "cpu")


def _seeded_image(h=7, w=13, seed=3):
    img = np.random.RandomState(seed).rand(h, w, 3).astype(np.float32) * 1.2 - 0.1
    img[0, 0] = (0.0, 1.0, 0.5 / 255)  # the clip ends and a rounding edge
    return img


def test_pfm_and_npz_match_jax(tmp_path):
    img = _seeded_image()
    io.write_pfm(str(tmp_path / "p.pfm"), img)
    jax_io.write_pfm(str(tmp_path / "j.pfm"), img)
    assert (tmp_path / "p.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    back = io.read_pfm(str(tmp_path / "p.pfm"))
    assert np.array_equal(_bits(back), _bits(img))
    assert np.array_equal(_bits(back), _bits(jax_io.read_pfm(str(tmp_path / "p.pfm"))))
    io.write_npz(str(tmp_path / "p.npz"), img, iteration=4)
    jax_io.write_npz(str(tmp_path / "j.npz"), img, iteration=4)
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["image", "iteration"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("shape", [(7, 13), (1, 1)], ids=["7x13", "1x1"])
def test_png_matches_jax(tmp_path, shape):
    img = _seeded_image(*shape)
    io.write_png(str(tmp_path / "p.png"), img)
    jax_io.write_png(str(tmp_path / "j.png"), img)
    with Image.open(tmp_path / "p.png") as a, Image.open(tmp_path / "j.png") as b:
        assert a.mode == b.mode == "RGB"
        want = np.asarray(b)
        assert np.array_equal(np.asarray(a), want)
    rgba = io.read_png(str(tmp_path / "p.png"))
    assert np.array_equal(rgba[..., :3], want) and (rgba[..., 3] == 255).all()


def test_render_stats_summary_matches_jax():
    ours, theirs = tools.RenderStats(print_every=0), jax_tools.RenderStats(print_every=0)
    assert ours.summary() == theirs.summary() == "no frames"
    for dt in (0.0123, 0.0045, 0.5):
        ours._times.append(dt)
        theirs._times.append(dt)
    assert ours.summary() == theirs.summary()
    ours.begin()
    ours.end()
    assert ours.total_frames == 1 and ours.summary().startswith("4 frames: avg ")

"""The port's JPEG decoder (``tracer_torch.render.jpeg`` and the C helper
``tracer_torch/csrc/image_codec.c``) against PIL, which the JAX package
reads images with.

* ``jpeg.decode`` bitwise equal to PIL's ``convert("RGBA")`` on JPEGs that
  PIL writes here from seeded images: quality 50 and 95; 4:4:4, 4:2:2 and
  4:2:0 chroma and greyscale; plain, ``optimize=True``, a restart interval
  and ``progressive=True`` (with a restart interval too); sizes 1x1, 7x13,
  37x29 and 64x48 (partial MCUs at the right and bottom edges, and chroma
  planes of one or two samples, which libjpeg-turbo upsamples by
  replication). No case needs a tolerance.
* The fixtures ``tests/fixtures/texture_{420,grey,progressive}.jpg`` (what
  ``chip_smoke.py`` decodes on the card's host) equal the PIL decodes
  stored beside them (``*.pil.png``) and PIL's decode here.
* ``texture.load_image`` bitwise equal to ``tracer.render.texture.load_image``
  on a JPEG.
* Frames the decoder does not serve raise ``ValueError`` naming the file:
  arithmetic coding, 12-bit precision, CMYK (Adobe) and a truncated file.
* ``W3 E3`` at 16x16 with a PIL-written 4:2:0 JPEG as its ``grass.jpg`` on
  the plane that ``chip_smoke.with_textured_plane`` marks textured, built
  and rendered by both packages (the JAX side in a child process): the
  frames agree at ``DIRECT_RTOL`` on every pixel without a lookup near a
  texel edge (``_direct_grad.TexelEdges``), and the textures bit for bit.

``PYTHONPATH=. python tests/test_torch_jpeg.py time`` prints the decode times of a
2048x1024 JPEG and a 2048x1024 Paeth-filtered PNG against PIL's.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _direct_grad import TexelEdges
from _share_cores import share_cores
from PIL import Image

from chip_smoke import DIRECT_RTOL, FIXTURES, with_textured_plane

from tracer.render import texture as jax_texture
from tracer_torch import io
from tracer_torch.render import integrator, jpeg, texture
from tracer_torch.scenes.build import build_scene
from tracer_torch.scenes.registry import get_scene

share_cores()

REPO = Path(__file__).resolve().parents[1]
JPEG_FIXTURES = ("texture_420", "texture_grey", "texture_progressive")
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": None}
OPTIONS = {"plain": {}, "optimize": {"optimize": True},
           "restart": {"restart_marker_blocks": 3}, "progressive": {"progressive": True},
           "progressive restart": {"progressive": True, "restart_marker_blocks": 2}}


def seeded_image(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: gradients plus seeded noise (JPEG-like content with
    some detail)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * 2 + y * 9) % 256, (x * y) % 256], -1)
    return (base + rs.randint(0, 60, (h, w, 3))).clip(0, 255).astype(np.uint8)


def pil_rgba(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def write_jpeg(path, h, w, seed, sub, **kw):
    px = seeded_image(h, w, seed)
    if sub is None:
        Image.fromarray(px[..., 0]).save(path, **kw)
    else:
        Image.fromarray(px).save(path, subsampling=sub, **kw)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 29), (64, 48)],
                         ids=["1x1", "7x13", "37x29", "64x48"])
def test_decode_matches_pil(tmp_path, size, sub, option):
    for quality in (50, 95):
        path = str(tmp_path / f"q{quality}.jpg")
        write_jpeg(path, size[1], size[0], size[0] + quality, SUBSAMPLING[sub], quality=quality,
                   **OPTIONS[option])
        got = jpeg.decode(path)
        want = pil_rgba(path)
        assert got.dtype == np.uint8 and got.shape == want.shape == (size[1], size[0], 4)
        assert np.array_equal(got, want), f"quality {quality}: max difference " \
            f"{np.abs(got.astype(int) - want).max()}"


@pytest.mark.parametrize("name", JPEG_FIXTURES)
def test_fixtures_match_stored_pil_decode(name):
    path = str(FIXTURES / f"{name}.jpg")
    got = jpeg.decode(path)
    assert np.array_equal(got, io.read_png(str(FIXTURES / f"{name}.pil.png")))
    assert np.array_equal(got, pil_rgba(path))
    assert os.path.getsize(path) < 16384


def test_load_image_matches_jax(tmp_path):
    path = str(tmp_path / "grass.jpg")
    write_jpeg(path, 29, 37, 5, 2, quality=80)
    got = texture.load_image(path, "cpu")
    want = jax_texture.load_image(path)
    assert got.kind == want.kind == texture.ENV_LDR
    a, b = got.data.numpy(), np.asarray(want.data)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (29, 37, 4)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _patched(tmp_path, name, marker: bytes, at: int, value: int) -> str:
    """A PIL-written JPEG with one byte changed ``at`` bytes after the
    first ``marker``."""
    path = tmp_path / f"{name}.jpg"
    write_jpeg(str(path), 16, 16, 0, 2, quality=75)
    data = bytearray(path.read_bytes())
    data[data.index(marker) + at] = value
    path.write_bytes(bytes(data))
    return str(path)


@pytest.mark.parametrize("how", ["arithmetic", "12-bit", "cmyk", "truncated"])
def test_unsupported_jpeg_raises(tmp_path, how):
    if how == "arithmetic":
        path = _patched(tmp_path, how, b"\xff\xc0", 1, 0xC9)
    elif how == "12-bit":
        path = _patched(tmp_path, how, b"\xff\xc0", 4, 12)
    elif how == "cmyk":
        path = str(tmp_path / "cmyk.jpg")
        Image.fromarray(seeded_image(8, 8, 0)).convert("CMYK").save(path)
    else:
        path = str(tmp_path / "truncated.jpg")
        write_jpeg(path, 16, 16, 0, 2, quality=75)
        Path(path).write_bytes(Path(path).read_bytes()[:100])
    with pytest.raises(ValueError, match=path):
        jpeg.decode(path)


def _w3e3_desc(get, path: str):
    d = with_textured_plane(get("W3 E3"))
    return dataclasses.replace(d, texture=path,
                               cfg=dataclasses.replace(d.cfg, width=16, height=16))


def _write_jax_side(path: str, out: str) -> None:
    import jax

    from tracer.render import integrator as jax_integrator
    from tracer.scenes import build_scene as jax_build_scene
    from tracer.scenes import get_scene as jax_get_scene

    jax.config.update("jax_platforms", "cpu")
    scene, cfg = jax_build_scene(_w3e3_desc(jax_get_scene, path))
    img = jax.jit(jax_integrator.render_sample, static_argnames="cfg")(scene, cfg=cfg)
    with open(out, "wb") as f:
        pickle.dump(dict(image=np.asarray(img), texture=np.asarray(scene.texture.data)), f)


def test_w3e3_jpeg_texture_frame_matches_jax(tmp_path):
    path = str(tmp_path / "grass.jpg")
    write_jpeg(path, 24, 32, 3, 2, quality=85)
    out = tmp_path / "jax.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "TRACER_NO_SCENE_CACHE": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), str(REPO / "tests"),
                                                       os.environ.get("PYTHONPATH")]))}
    run = subprocess.run([sys.executable, __file__, "jax", path, str(out)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        side = pickle.load(f)
    scene, cfg = build_scene(_w3e3_desc(get_scene, path), "cpu")
    assert scene.texture is not None and cfg.plane_texture and cfg.subdivs > 1
    assert np.array_equal(scene.texture.data.numpy().view(np.uint32),
                          side["texture"].view(np.uint32))
    with torch.no_grad(), TexelEdges() as edges:
        img = integrator.render_sample(scene, cfg).numpy()
    keep = ~edges.pixels(cfg.width * cfg.height)
    assert keep.mean() > 0.5
    textured = img[keep]
    np.testing.assert_allclose(textured, side["image"][keep], rtol=DIRECT_RTOL, atol=0)
    assert float(np.abs(textured).sum()) > 0


def _time_decoders(out_dir: Path) -> None:
    """Decode times of a 2048x1024 JPEG (quality 90, 4:2:0) and a 2048x1024
    RGB PNG with every row Paeth-filtered, best of 5, against PIL."""
    from test_torch_texture import _chunk, _filter_row

    rs = np.random.RandomState(0)
    img = (np.cumsum(rs.randint(0, 256, (1024, 2048, 3)), axis=1) // 50).astype(np.uint8)
    jpg, png = out_dir / "big.jpg", out_dir / "paeth.png"
    Image.fromarray(img).save(jpg, quality=90)
    rows, prev = [], np.zeros(2048 * 3, np.uint8)
    for y in range(1024):
        rows.append(_filter_row(4, img[y].reshape(-1), prev, 3))
        prev = img[y].reshape(-1)
    import struct
    import zlib

    png.write_bytes(b"\x89PNG\r\n\x1a\n"
                    + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2048, 1024, 8, 2, 0, 0, 0))
                    + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))
    for name, path, ours in (("JPEG", jpg, jpeg.decode), ("Paeth PNG", png, io.read_png)):
        assert np.array_equal(ours(str(path)), pil_rgba(path))
        times = {}
        for who, fn in (("port", ours), ("PIL", pil_rgba)):
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                fn(str(path))
                best = min(best, time.perf_counter() - t0)
            times[who] = best
        print(f"{name} 2048x1024 ({path.stat().st_size} bytes): port {times['port'] * 1e3:.1f} ms, "
              f"PIL {times['PIL'] * 1e3:.1f} ms (best of 5)")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _write_jax_side(sys.argv[2], sys.argv[3])
    else:
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            _time_decoders(Path(d))

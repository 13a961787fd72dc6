"""The port's image loaders against the JAX package's and PIL.

* ``load_rgbe_png`` on ``tests/fixtures/tiny_env.hdr.png``: bitwise equal
  to ``tracer.render.texture.load_rgbe_png``.
* ``tracer_torch.io.read_png`` (a decoder on the standard library's
  ``zlib`` and the port's C unfilter; the card's machine has no PIL):
  bitwise equal to PIL's ``convert("RGBA")`` on seeded images written by
  PIL and by hand, every 8-bit colour type (grey, grey + alpha, RGB, RGBA,
  palette; with tRNS too) under every filter type, an odd width and a
  1-pixel image; the unfilter at 1 to 4 bytes per pixel under all five
  filter types; Adam7-interlaced files built by hand (each pass's rows
  filtered with types 0 and 4); and ``load_image`` bitwise equal to the JAX
  package's.
* ``_read_radiance_rgbe`` and ``load_radiance_hdr``: bitwise equal to the
  JAX package's on seeded Radiance files (adaptive-RLE and flat scanlines)
  written here, and equal to the bytes written.
* Malformed PNG and Radiance files raise ``ValueError`` naming the file
  (an interlaced file whose data is laid out as a plain one among them); a
  JPEG that exists decodes as PIL decodes it (``tests/test_torch_jpeg.py``
  holds the decoder to PIL); a missing image is ``None`` with the JAX
  package's note.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest
from _share_cores import share_cores
from PIL import Image

from tracer.render import texture as jax_texture

from tracer_torch import io
from tracer_torch.render import texture
from tracer_torch.scenes.build import load_texture

share_cores()

FIXTURE = "tests/fixtures/tiny_env.hdr.png"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pil_rgba(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> bytes:
    """PNG filter ``kind`` applied to one row of bytes (the encoder's side
    of section 9 of the PNG spec)."""
    x = row.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def _write_png(path, px: np.ndarray, ctype: int, filters, palette=None, trns=None,
               depth=8, interlace=0, width=None) -> None:
    """A PNG written by hand: ``px`` (H, W, channels) uint8, row y filtered
    with ``filters[y % len(filters)]``; ``width`` in pixels where samples
    of fewer than 8 bits are packed into the bytes of ``px``."""
    h, w, ch = px.shape
    rows, prev = [], np.zeros(w * ch, np.uint8)
    for y in range(h):
        row = px[y].reshape(-1)
        rows.append(_filter_row(filters[y % len(filters)], row, prev, ch))
        prev = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", width or w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    raw = zlib.compress(b"".join(rows))
    data += _chunk(b"IDAT", raw[:len(raw) // 2]) + _chunk(b"IDAT", raw[len(raw) // 2:])
    data += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def test_load_rgbe_png_matches_jax():
    got = texture.load_rgbe_png(FIXTURE, "cpu")
    want = jax_texture.load_rgbe_png(FIXTURE)
    assert got.kind == want.kind == texture.ENV_RGBE
    a, b = got.data.numpy(), np.asarray(want.data)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (8, 16, 4)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert np.array_equal(io.read_png(FIXTURE), _pil_rgba(FIXTURE))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P+tRNS", "L+tRNS",
                                  "RGB+tRNS"])
@pytest.mark.parametrize("shape", [(7, 13), (1, 1)], ids=["7x13", "1x1"])
def test_read_png_matches_pil_on_pil_written(tmp_path, mode, shape):
    rs = np.random.RandomState(len(mode) * 10 + shape[1])
    h, w = shape
    base = mode.split("+")[0]
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[base]
    px = rs.randint(0, 256, (h, w, ch)).astype(np.uint8)
    if base == "P":
        px = px % 5
    im = Image.fromarray(px[..., 0] if ch == 1 else px, "L" if base == "P" else base)
    kw = {}
    if base == "P":
        im = im.convert("P")
        im.putpalette(rs.randint(0, 256, 5 * 3).astype(np.uint8).tobytes())
        if mode == "P+tRNS":
            kw["transparency"] = bytes([0, 128, 255])
    elif mode == "L+tRNS":
        kw["transparency"] = int(px[0, 0, 0])
    elif mode == "RGB+tRNS":
        kw["transparency"] = tuple(int(v) for v in px[0, 0])
    path = tmp_path / "pil.png"
    im.save(path, **kw)
    got = io.read_png(str(path))
    assert got.dtype == np.uint8 and np.array_equal(got, _pil_rgba(path))
    if mode in ("L+tRNS", "RGB+tRNS"):
        assert got[0, 0, 3] == 0
    elif mode == "P+tRNS":
        assert got[0, 0, 3] == (0, 128, 255, 255, 255)[px[0, 0, 0]]
    ja, jb = texture.load_image(str(path), "cpu"), jax_texture.load_image(str(path))
    assert np.array_equal(ja.data.numpy().view(np.uint32),
                          np.asarray(jb.data).view(np.uint32))


@pytest.mark.parametrize("ctype", sorted(CHANNELS))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_read_png_matches_pil_on_hand_written(tmp_path, ctype, filters):
    rs = np.random.RandomState(ctype * 7 + len(filters) + filters[0])
    ch = CHANNELS[ctype]
    px = rs.randint(0, 256, (9, 11, ch)).astype(np.uint8)
    palette = trns = None
    if ctype == 3:
        px = px % 7
        palette = rs.randint(0, 256, (7, 3)).astype(np.uint8)
        trns = bytes([200, 0, 17])
    path = tmp_path / "hand.png"
    _write_png(path, px, ctype, filters, palette, trns)
    got = io.read_png(str(path))
    want = _pil_rgba(path)
    assert np.array_equal(got, want)
    if ctype == 6:
        assert np.array_equal(got, px)


def _packed(idx: np.ndarray, depth: int) -> np.ndarray:
    """(H, W) values of ``depth`` bits packed most significant first into
    (H, ceil(W * depth / 8), 1) bytes."""
    h, w = idx.shape
    bits = (idx[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    bits = bits.reshape(h, w * depth).astype(np.uint8)
    return np.packbits(bits, axis=1)[..., None]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_read_png_packed_palette_matches_pil(tmp_path, depth):
    rs = np.random.RandomState(depth)
    idx = rs.randint(0, 1 << depth, (5, 11)).astype(np.uint8)
    palette = rs.randint(0, 256, (1 << depth, 3)).astype(np.uint8)
    path = tmp_path / "packed.png"
    _write_png(path, _packed(idx, depth), 3, (4, 1), palette, bytes([9]), depth=depth,
               width=11)
    got = io.read_png(str(path))
    assert np.array_equal(got, _pil_rgba(path))
    assert np.array_equal(got[..., :3], palette[idx])


def _rle_channel(values: np.ndarray) -> bytes:
    """Radiance adaptive-RLE of one channel of a scanline: runs of 3 or
    more equal bytes (at most 127) as 128 + n, the rest as literals of at
    most 128."""
    out, lit, x, w = bytearray(), bytearray(), 0, values.shape[0]

    def flush():
        while lit:
            n = min(len(lit), 128)
            out.append(n)
            out.extend(lit[:n])
            del lit[:n]

    while x < w:
        n = 1
        while x + n < w and n < 127 and values[x + n] == values[x]:
            n += 1
        if n >= 3:
            flush()
            out += bytes([128 + n, int(values[x])])
            x += n
        else:
            lit.append(int(values[x]))
            x += 1
    flush()
    return bytes(out)


def _write_hdr(path, rgbe: np.ndarray, rle: bool, magic=b"#?RADIANCE", res=None) -> None:
    h, w, _ = rgbe.shape
    body = bytearray()
    for y in range(h):
        if rle:
            body += bytes([2, 2, w >> 8, w & 0xFF])
            for c in range(4):
                body += _rle_channel(rgbe[y, :, c])
        else:
            body += rgbe[y].tobytes()
    res = res or f"-Y {h} +X {w}".encode()
    with open(path, "wb") as f:
        f.write(magic + b"\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=1.0\n\n" + res + b"\n" + bytes(body))


def _seeded_rgbe(seed: int, shape) -> np.ndarray:
    """Random RGBE bytes with runs (so RLE has runs and literals)."""
    rs = np.random.RandomState(seed)
    rgbe = rs.randint(0, 256, (*shape, 4)).astype(np.uint8)
    rgbe[:, ::3] = rgbe[:, :1]  # repeated columns
    rgbe[:, 5:19, 3] = 130  # a long run in the exponent
    return rgbe


@pytest.mark.parametrize("rle", [True, False], ids=["rle", "flat"])
def test_read_radiance_matches_jax(tmp_path, rle):
    rgbe = _seeded_rgbe(3 if rle else 4, (6, 37))
    path = str(tmp_path / "seeded.hdr")
    _write_hdr(path, rgbe, rle)
    got = texture._read_radiance_rgbe(path)
    assert np.array_equal(got, jax_texture._read_radiance_rgbe(path))
    assert np.array_equal(got, rgbe)
    a = texture.load_radiance_hdr(path, "cpu")
    b = jax_texture.load_radiance_hdr(path)
    assert a.kind == b.kind == texture.ENV_RGBE
    assert np.array_equal(a.data.numpy().view(np.uint32), np.asarray(b.data).view(np.uint32))
    # The build's dispatch reads .hdr files as Radiance, whatever the flag.
    c = load_texture(path, False, "cpu")
    assert c.kind == texture.ENV_RGBE and np.array_equal(c.data.numpy(), a.data.numpy())


def _corrupt(path, how: str) -> None:
    data = bytearray(open(path, "rb").read())
    if how == "crc":
        data[-20] ^= 0xFF  # inside the last IDAT's payload
    elif how == "truncated":
        data = data[:len(data) // 2]
    elif how == "signature":
        data[1] = ord("Q")
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_unfilter_helper_matches_pil(tmp_path, bpp):
    """The C unfilter at 1 to 4 bytes per pixel (grey, grey + alpha, RGB,
    RGBA), every row of a 33x47 seeded image under one of the five filter
    types in turn, and the helper called alone against PIL's pixels."""
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    px = np.random.RandomState(bpp).randint(0, 256, (47, 33, bpp)).astype(np.uint8)
    path = str(tmp_path / f"bpp{bpp}.png")
    _write_png(path, px, ctype, (0, 1, 2, 3, 4, 4, 3, 2, 1))
    assert np.array_equal(io.read_png(path), _pil_rgba(path))
    rows, prev = [], np.zeros(33 * bpp, np.uint8)
    for y in range(47):
        rows.append(_filter_row((y + bpp) % 5, px[y].reshape(-1), prev, bpp))
        prev = px[y].reshape(-1)
    out = io._unfilter(path, b"".join(rows), 47, 33 * bpp, bpp)
    assert np.array_equal(out, px.reshape(47, -1))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _write_adam7(path, px: np.ndarray, ctype: int) -> None:
    """An Adam7-interlaced 8-bit PNG written by hand: each pass's sub-image
    filtered row by row, types 0 and 4 in turn."""
    h, w, ch = px.shape
    rows = []
    for i, (x0, y0, dx, dy) in enumerate(ADAM7):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = np.zeros(sub.shape[1] * ch, np.uint8)
        for y in range(sub.shape[0]):
            row = sub[y].reshape(-1)
            rows.append(_filter_row((0, 4)[(y + i) % 2], row, prev, ch))
            prev = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 1))
    data += _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("ctype", [0, 2, 4, 6], ids=["L", "RGB", "LA", "RGBA"])
@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (13, 7), (29, 37)],
                         ids=["1x1", "2x3", "7x13", "37x29"])
def test_adam7_matches_pil(tmp_path, shape, ctype):
    ch = CHANNELS[ctype]
    px = np.random.RandomState(ctype * 100 + shape[1]).randint(0, 256, (*shape, ch))
    path = str(tmp_path / "adam7.png")
    _write_adam7(path, px.astype(np.uint8), ctype)
    with Image.open(path) as im:
        assert im.info.get("interlace") == 1
    assert np.array_equal(io.read_png(path), _pil_rgba(path))


@pytest.mark.parametrize("how", ["crc", "truncated", "signature", "16-bit", "interlaced",
                                 "2-bit grey", "bad filter"])
def test_malformed_png_raises(tmp_path, how):
    path = tmp_path / f"bad {how}.png"
    px = np.random.RandomState(0).randint(0, 256, (4, 5, 3)).astype(np.uint8)
    if how == "16-bit":
        Image.fromarray(px[..., 0].astype(np.uint16) * 200).save(path)
    elif how == "interlaced":
        _write_png(path, px, 2, (0,), interlace=1)
    elif how == "2-bit grey":
        _write_png(path, _packed(px[..., 0] % 4, 2), 0, (0,), depth=2, width=5)
    elif how == "bad filter":
        _write_png(path, px, 2, (5,))
    else:
        _write_png(path, px, 2, (1,))
        _corrupt(path, how)
    with pytest.raises(ValueError, match=str(path)):
        io.read_png(str(path))
    with pytest.raises(ValueError):
        load_texture(str(path), True, "cpu")


@pytest.mark.parametrize("how", ["magic", "orientation"])
def test_malformed_radiance_raises(tmp_path, how):
    path = str(tmp_path / "bad.hdr")
    rgbe = _seeded_rgbe(0, (2, 9))
    if how == "magic":
        _write_hdr(path, rgbe, True, magic=b"P6")
    else:
        _write_hdr(path, rgbe, True, res=b"+Y 2 +X 9")
    with pytest.raises(ValueError, match=path):
        texture._read_radiance_rgbe(path)
    with pytest.raises(ValueError):
        jax_texture._read_radiance_rgbe(path)


def test_jpeg_that_exists_decodes_and_missing_image_is_none(tmp_path, capfd):
    path = str(tmp_path / "grass.jpg")
    px = np.random.RandomState(3).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    Image.fromarray(px).save(path)
    want = _pil_rgba(path).astype(np.float32) / 255.0
    for got in (load_texture(path, False, "cpu"), texture.load_image(path, "cpu")):
        assert np.array_equal(got.data.numpy(), want)
    assert load_texture(str(tmp_path / "missing.jpg"), False, "cpu") is None
    assert "missing" in capfd.readouterr().err

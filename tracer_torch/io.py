"""Image export and PNG decoding (port of ``tracer.io``).

PNG (8-bit display image), PFM (linear float radiance, readable by HDR
tools) and NPZ (exact float32 for diffing). The card's machine has no PIL,
so PNG is written and read here on the standard library's ``zlib``:
``write_png`` stores 8-bit RGB rows unfiltered; ``read_png`` decodes
8-bit PNGs (grey, grey + alpha, RGB, RGBA) and palette PNGs of 1 to 8
bits, plain or Adam7-interlaced, under every filter type, to what PIL's
``convert("RGBA")`` gives, and raises ``ValueError`` naming the file for
anything else. The row unfilter runs in the port's C helper
(``tracer_torch/csrc/image_codec.c``, built at first use; a failed
compile raises).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from tracer_torch._build import CSRC, shared_library

CODEC_SOURCE = CSRC / "image_codec.c"

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels per pixel of each colour type: grey, RGB, palette, grey +
# alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0, 1] (already display-transformed); each
    channel is stored as ``clip(x * 255 + 0.5, 0, 255)`` truncated to 8
    bits, as ``tracer.io.write_png`` rounds it."""
    arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))


@functools.cache
def codec_lib() -> ctypes.CDLL:
    """The image helper, PNG unfilter and JPEG stages (compiled at first
    use; raises if ``gcc`` fails)."""
    path, _ = shared_library("image_codec", ["gcc", "-O3", "-shared", "-fPIC"],
                             [CODEC_SOURCE])
    so = ctypes.CDLL(str(path))
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64, c32 = ctypes.c_int64, ctypes.c_int32
    so.png_unfilter.restype = i64
    so.png_unfilter.argtypes = [u8, i64, i64, i64, u8]
    so.jpeg_decode_scan.restype = i64
    so.jpeg_decode_scan.argtypes = [u8, i64, i64, c32, c32, i32, c32, c32, c32, c32, c32, c32,
                                    c32, u8, u8, i16]
    so.jpeg_output.restype = i64
    so.jpeg_output.argtypes = [i16, u16, c32, i32, c32, c32, u8]
    return so


def _chunks(path: str, data: bytes):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n


def _unfilter(path: str, raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec, section 9) in the C helper:
    (h, stride) uint8."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    rc = codec_lib().png_unfilter(np.frombuffer(raw, np.uint8), h, stride, bpp, out)
    if rc:
        raise ValueError(f"{path}: row {-rc - 1} has filter type {raw[(-rc - 1) * (stride + 1)]}")
    return out


# Adam7 passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _pixels(path: str, raw: bytes, w: int, h: int, depth: int, ch: int) -> np.ndarray:
    """Unfilter one (sub-)image of w x h pixels and unpack it: (h, w, ch)
    uint8 samples (palette indices of fewer than 8 bits widened)."""
    if depth == 8:
        return _unfilter(path, raw, h, w * ch, ch).reshape(h, w, ch)
    # palette indices packed several to a byte, most significant first
    rows = _unfilter(path, raw, h, (w * depth + 7) // 8, 1)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :w, None]


def _deinterlace(path: str, raw: bytes, w: int, h: int, depth: int, ch: int) -> np.ndarray:
    """The seven Adam7 passes, each unfiltered on its own, put in place."""
    px = np.empty((h, w, ch), np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass stores nothing, not even filter bytes
        n = ph * ((pw * ch * depth + 7) // 8 + 1)
        px[y0::dy, x0::dx] = _pixels(path, raw[pos:pos + n], pw, ph, depth, ch)
        pos += n
    if pos != len(raw):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, expected {pos}")
    return px


def read_png(path: str) -> np.ndarray:
    """Decode a PNG (plain or Adam7-interlaced) to (H, W, 4) uint8 RGBA, as PIL's
    ``Image.open(path).convert("RGBA")`` gives it: grey spreads to RGB,
    missing alpha is 255, palette entries take their tRNS alpha, and a
    grey or RGB tRNS colour key makes matching pixels transparent. Palette
    indices may take 1, 2, 4 or 8 bits. Raises ``ValueError`` naming
    ``path`` for other PNGs (16-bit, grey of fewer than 8 bits) and
    malformed files."""
    with open(path, "rb") as f:
        data = f.read()
    header = palette = trns = None
    idat = []
    for kind, payload in _chunks(path, data):
        if header is None and kind != b"IHDR":
            raise ValueError(f"{path}: the first chunk is {kind!r}, not IHDR")
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"{path}: IHDR of {len(payload)} bytes")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3:
                raise ValueError(f"{path}: PLTE of {len(payload)} bytes")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype} (only 8-bit "
                         "grey, grey + alpha, RGB, RGBA, and palette of 1-8 bits)")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: interlace method {interlace}")
    if comp or filt:
        raise ValueError(f"{path}: compression method {comp}, filter method {filt}")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image {w}x{h}")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    ch = _CHANNELS[ctype]
    if interlace:
        px = _deinterlace(path, raw, w, h, depth, ch)
    else:
        px = _pixels(path, raw, w, h, depth, ch)

    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        idx = px[..., 0]
        if int(idx.max()) >= palette.shape[0]:
            raise ValueError(f"{path}: palette index {int(idx.max())} beyond "
                             f"{palette.shape[0]} entries")
        alpha = np.full(palette.shape[0], 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:palette.shape[0]]
            alpha[:t.shape[0]] = t
        out[..., :3] = palette[idx]
        out[..., 3] = alpha[idx]
        return out
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., :3]
    out[..., 3] = px[..., -1] if ctype in (4, 6) else 255
    if trns is not None and ctype in (0, 2):
        key = struct.unpack(f">{len(trns) // 2}H", trns[:len(trns) // 2 * 2])
        if len(key) == ch:
            out[(px == np.asarray(key)).all(axis=-1), 3] = 0
    return out


def write_pfm(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float32 linear radiance. PFM stores bottom-up."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header != b"PF":
            raise ValueError(f"{path}: not a colour PFM file")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4").reshape(h, w, 3)
    return np.flipud(data).copy()


def write_npz(path: str, img: np.ndarray, **extra) -> None:
    np.savez_compressed(path, image=np.asarray(img, np.float32), **extra)

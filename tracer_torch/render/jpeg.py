"""Baseline and progressive JPEG decoding (the counterpart of PIL's JPEG
reader, which ``tracer.render.texture`` uses).

The markers are parsed here; the entropy decoding, dequantisation, IDCT,
upsampling and YCbCr -> RGB conversion run in the port's C helper
(``tracer_torch/csrc/image_codec.c``, compiled with ``gcc`` into
``build/tracer_torch/`` at first use; a failed compile raises). The helper
follows libjpeg-turbo's default path, so ``decode`` returns what PIL's
``Image.open(path).convert("RGBA")`` gives, bit for bit.

Served: SOF0, SOF1 and SOF2 frames of 8-bit precision with 1 (grey) or 3
(YCbCr) components, luma sampling factors 1x1, 2x1, 1x2 and 2x2, Huffman
coding with restart intervals, and every progressive scan kind (DC and AC,
first and refinement passes, EOB runs). Arithmetic coding, lossless and
hierarchical frames, 12-bit precision, CMYK and Adobe RGB files raise
``ValueError`` naming the file and the marker.
"""

from __future__ import annotations

import struct

import numpy as np

from tracer_torch.io import codec_lib

# Zigzag position -> natural (row-major) index of the 8x8 block.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_SOF_NAMES = {0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (hierarchical)",
              0xC6: "SOF6 (hierarchical)", 0xC7: "SOF7 (hierarchical lossless)",
              0xC9: "SOF9 (arithmetic)", 0xCA: "SOF10 (arithmetic progressive)",
              0xCB: "SOF11 (arithmetic lossless)", 0xCD: "SOF13 (arithmetic)",
              0xCE: "SOF14 (arithmetic)", 0xCF: "SOF15 (arithmetic)"}


class _Frame:
    def __init__(self, path, marker, payload):
        precision, self.H, self.W, n = struct.unpack_from(">BHHB", payload)
        if precision != 8:
            raise ValueError(f"{path}: {precision}-bit precision (SOF{marker - 0xC0}); only "
                             "8-bit JPEGs are decoded")
        if n not in (1, 3):
            raise ValueError(f"{path}: {n} components (SOF{marker - 0xC0}); only grey and "
                             "YCbCr JPEGs are decoded")
        if self.H == 0 or self.W == 0:
            raise ValueError(f"{path}: image size {self.W}x{self.H} (a DNL marker is not read)")
        self.progressive = marker == 0xC2
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = struct.unpack_from(">BBB", payload, 6 + 3 * i)
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        hmax, vmax = max(self.h), max(self.v)
        if n == 3 and not ((hmax, vmax) in ((1, 1), (2, 1), (1, 2), (2, 2))
                           and self.h[1:] == [1, 1] and self.v[1:] == [1, 1]
                           and (self.h[0], self.v[0]) == (hmax, vmax)):
            raise ValueError(f"{path}: sampling factors {list(zip(self.h, self.v))} "
                             f"(SOF{marker - 0xC0}); luma 1x1, 2x1, 1x2 or 2x2 over 1x1 "
                             "chroma are decoded")
        self.mcus_x = -(-self.W // (8 * hmax))
        self.mcus_y = -(-self.H // (8 * vmax))
        # Coefficient planes over the interleaved MCU grid; each component
        # also has its own block grid (what a non-interleaved scan visits).
        self.bw = [self.mcus_x * h for h in self.h]
        self.bh = [self.mcus_y * v for v in self.v]
        ceil = lambda a, b: -(-a // b)
        self.cw = [ceil(ceil(self.W * h, hmax), 8) for h in self.h]
        self.ch = [ceil(ceil(self.H * v, vmax), 8) for v in self.v]
        sizes = [bw * bh * 64 for bw, bh in zip(self.bw, self.bh)]
        self.offset = list(np.cumsum([0] + sizes[:-1]))
        self.coefs = np.zeros(sum(sizes), np.int16)


def _segments(path, data):
    """(marker, payload, end) of each marker segment from SOI; the payload
    of SOS is its header, and ``end`` the offset after it."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: no marker at offset {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            yield marker, b"", pos
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError(f"{path}: truncated segment of marker 0x{marker:02X}")
        (n,) = struct.unpack_from(">H", data, pos)
        payload = data[pos + 2:pos + n]
        if len(payload) != n - 2:
            raise ValueError(f"{path}: truncated segment of marker 0x{marker:02X}")
        pos = yield marker, payload, pos + n


def decode(path: str) -> np.ndarray:
    """Decode the JPEG at ``path`` to (H, W, 4) uint8 RGBA, as PIL's
    ``Image.open(path).convert("RGBA")`` does: grey spreads to RGB and
    alpha is 255. Raises ``ValueError`` naming ``path`` for the files that
    the module docstring lists as not decoded, and for malformed ones."""
    with open(path, "rb") as f:
        data = f.read()
    buf = np.frombuffer(data, np.uint8)
    so = codec_lib()
    qt = np.zeros((4, 64), np.uint16)
    huff_bits = np.zeros((8, 16), np.uint8)
    huff_vals = np.zeros((8, 256), np.uint8)
    frame, restart = None, 0
    segs = _segments(path, data)
    marker, payload, end = next(segs)
    while marker != 0xD9:
        if marker in _SOF_NAMES:
            raise ValueError(f"{path}: {_SOF_NAMES[marker]} frames are not decoded")
        if marker == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12 \
                and payload[11] != 1:
            raise ValueError(f"{path}: Adobe APP14 colour transform {payload[11]} "
                             "(RGB or CMYK); only YCbCr JPEGs are decoded")
        if marker == 0xDB:
            p = 0
            while p < len(payload):
                pq, tq = payload[p] >> 4, payload[p] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(payload[p + 1:p + 1 + size], ">u2" if pq else np.uint8)
                qt[tq & 3, _ZIGZAG] = vals
                p += 1 + size
        elif marker == 0xC4:
            p = 0
            while p < len(payload):
                tc, th = payload[p] >> 4, payload[p] & 15
                bits = np.frombuffer(payload[p + 1:p + 17], np.uint8)
                n = int(bits.sum())
                t = (4 if tc else 0) + (th & 3)
                huff_bits[t] = bits
                huff_vals[t] = 0
                huff_vals[t, :n] = np.frombuffer(payload[p + 17:p + 17 + n], np.uint8)
                p += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):
            frame = _Frame(path, marker, payload)
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", payload)
        elif marker == 0xDC:
            raise ValueError(f"{path}: DNL marker (image height defined after the scan)")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: SOS before a frame header")
            ns = payload[0]
            rows = []
            for i in range(ns):
                cid, tables = payload[1 + 2 * i], payload[2 + 2 * i]
                c = frame.ids.index(cid)
                rows.append([frame.h[c], frame.v[c], frame.bw[c], frame.cw[c], frame.ch[c],
                             frame.offset[c], tables >> 4 & 3, tables & 3])
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            end = so.jpeg_decode_scan(
                buf, len(data), end, int(frame.progressive), ns, np.asarray(rows, np.int32),
                frame.mcus_x, frame.mcus_y, ss, se, a >> 4, a & 15, restart, huff_bits,
                huff_vals, frame.coefs)
            if end < 0:
                raise ValueError(f"{path}: invalid Huffman table in a scan (SOS)")
        marker, payload, end = segs.send(end)
    if frame is None:
        raise ValueError(f"{path}: no frame header (SOF0, SOF1 or SOF2)")
    n = len(frame.ids)
    comps = np.asarray([[frame.h[c], frame.v[c], frame.bw[c], frame.bh[c], frame.offset[c],
                         frame.tq[c] & 3, 0, 0] for c in range(n)], np.int32)
    px = np.empty((frame.H, frame.W, n), np.uint8)
    rc = so.jpeg_output(frame.coefs, qt, n, comps, frame.W, frame.H, px)
    if rc:
        raise ValueError(f"{path}: the decoder failed with code {rc}")
    out = np.empty((frame.H, frame.W, 4), np.uint8)
    out[..., :3] = px
    out[..., 3] = 255
    return out

"""Plane textures and environment maps (port of ``tracer.render.texture``).

A texture is a plain (H, W, 4) float32 tensor with values in [0, 1]; an
RGBE map keeps the shared exponent in its raw alpha channel and is decoded
at sample time as rgb * 2^(a * 255 - 128) (``w9e2.wgsl:242-245``). Plane
textures are sampled by the sampler mode of the ``use_texture`` uniform
(``TEX_*``, the UI enum ``TextureUse``, ``command.rs:50-55``); the lat-long
lookup is ``environment_map`` (``w9e2.wgsl:234-246``). atan2, acos and exp2
are taken in float64 and rounded, so the CPU and the card sample the same
texels with the same weights. The loaders read PNG through
``tracer_torch.io.read_png`` and JPEG through ``tracer_torch.render.jpeg``
(no PIL on the card's machine; both equal PIL's decode bit for bit), and
Radiance ``.hdr`` files in NumPy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tracer_torch import io
from tracer_torch.kernels import texel_place
from tracer_torch.math import vec

# TextureUse ids (command.rs:50-55)
TEX_NONE = 0
TEX_DEFAULT = 1
TEX_BILINEAR = 2
TEX_NEAREST = 3

# Environment-map encodings
ENV_LDR = 1  # plain rgb (w9e1: jpg background)
ENV_RGBE = 2  # rgb * 2^(a*255 - 128)  (w9e2.wgsl:242-245)


@dataclass(frozen=True)
class TextureBuf:
    data: torch.Tensor  # (H, W, 4) f32 in [0, 1] (RGBE maps keep the raw alpha)
    kind: int = ENV_LDR


def load_image(path: str, device) -> TextureBuf:
    """Load a PNG or JPEG as an Rgba8Unorm-equivalent float texture: (H, W,
    4) float32, the RGBA bytes over 255, as PIL's ``convert("RGBA")`` gives
    them. Other formats raise ``NotImplementedError``."""
    ext = path.lower().rsplit(".", 1)[-1]
    if ext == "png":
        rgba = io.read_png(path)
    elif ext in ("jpg", "jpeg"):
        from tracer_torch.render import jpeg

        rgba = jpeg.decode(path)
    else:
        raise NotImplementedError(f"{path}: only PNG and JPEG images are decoded")
    arr = rgba.astype(np.float32) / 255.0
    return TextureBuf(data=torch.as_tensor(arr, device=device), kind=ENV_LDR)


def load_rgbe_png(path: str, device) -> TextureBuf:
    """Load an ``.hdr.png`` whose alpha stores the shared RGBE exponent."""
    arr = io.read_png(path).astype(np.float32) / 255.0
    return TextureBuf(data=torch.as_tensor(arr, device=device), kind=ENV_RGBE)


def _read_radiance_rgbe(path: str) -> np.ndarray:
    """Parse a Radiance ``.hdr`` file to raw (H, W, 4) uint8 RGBE: both
    adaptive-RLE scanlines (the 0x02 0x02 marker format) and flat ones. The
    RGBE bytes are what the reference's ``.hdr.png`` stores in its channels
    (``w9e2.wgsl:242-245``)."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        res = f.readline().split()
        if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
            raise ValueError(f"{path}: unsupported orientation {res!r}")
        h, w = int(res[1]), int(res[3])
        data = np.frombuffer(f.read(), np.uint8)

    out = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (
            w >= 8
            and w < 32768
            and data[pos] == 2
            and data[pos + 1] == 2
            and (int(data[pos + 2]) << 8 | int(data[pos + 3])) == w
        ):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = int(data[pos])
                    pos += 1
                    if n > 128:  # run
                        out[y, x : x + n - 128, c] = data[pos]
                        pos += 1
                        x += n - 128
                    else:  # literal
                        out[y, x : x + n, c] = data[pos : pos + n]
                        pos += n
                        x += n
        else:  # flat scanline
            row = data[pos : pos + 4 * w].reshape(w, 4)
            out[y] = row
            pos += 4 * w
    return out


def load_radiance_hdr(path: str, device) -> TextureBuf:
    """Load a Radiance ``.hdr`` file into RGBE form (decoded at sample time
    like the reference's ``.hdr.png``: rgb * 2^(a * 255 - 128))."""
    rgbe = _read_radiance_rgbe(path)
    return TextureBuf(data=torch.as_tensor(rgbe.astype(np.float32) / 255.0, device=device),
                      kind=ENV_RGBE)


def _decode(texel, kind: int):
    rgb = texel[..., :3]
    if kind == ENV_RGBE:
        exponent = texel[..., 3] * 255.0 - 128.0
        rgb = rgb * vec.exp2(exponent)[..., None]
    return rgb


class _GatherTexels(torch.autograd.Function):
    """Texel rows of stacked taps, with a sorted placement for a backward.

    Forward: ``data[ys, xs]`` for the (k, N) int64 taps, the same gather as
    each tap's ``data[y, x]``; only the flat int32 ids ``y * W + x`` are
    saved. Backward: a stable sort of the ids, the cotangent rows permuted
    by it, and one ``texel_place.place`` into (H * W, 4), which sums each
    texel's rows in a fixed chunk order with no atomics, where PyTorch's
    index backward sums each texel's duplicates serially. Every channel gets
    its gradient (an RGBE map's exponent too).

    Both gathers index two dimensions (texel, channel): PyTorch gathers
    whole 16-byte rows by one index (``index_select``, ``t[idx]``) ~20 times
    slower on an H100 than it gathers by two."""

    @staticmethod
    def forward(ctx, data, ys, xs):
        ids = (ys * data.shape[1] + xs).to(torch.int32)
        ctx.save_for_backward(ids.reshape(-1))
        ctx.shape = data.shape
        return data[ys, xs]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        sids, perm = torch.sort(ids, stable=True)
        h, w, c = ctx.shape
        cols = torch.arange(c, device=g.device)
        placed = texel_place.place(sids, g.reshape(-1, c)[perm[:, None], cols], h * w)
        return placed.view(h, w, c), None, None


def _texels(tex: TextureBuf, taps):
    """``tex.data[y, x]`` for each ``(y, x)`` of ``taps`` (int64 index
    tensors of one shape): one (..., 4) tensor of texel rows a tap. Where a
    gradient of ``tex.data`` is wanted, the taps go through ``_GatherTexels``
    in one call; otherwise they are plain gathers."""
    data = tex.data
    if not (torch.is_grad_enabled() and data.requires_grad):
        return [data[y, x] for y, x in taps]
    ys, xs = zip(*taps)
    return _GatherTexels.apply(data, torch.stack(ys), torch.stack(xs)).unbind(0)


def sample_nearest(tex: TextureBuf, u, v):
    """Nearest-texel sample with repeat wrapping; uv in texture space (u
    right, v down)."""
    h, w = tex.data.shape[0], tex.data.shape[1]
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    x = torch.clamp((uu * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((vv * h).to(torch.int64), 0, h - 1)
    (c,) = _texels(tex, [(y, x)])
    return _decode(c, tex.kind)


def sample_bilinear(tex: TextureBuf, u, v):
    """Bilinear sample with repeat wrapping (4 gathers and a lerp)."""
    h, w = tex.data.shape[0], tex.data.shape[1]
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    fx = uu * w - 0.5
    fy = vv * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    t00, t10, t01, t11 = _texels(tex, [(y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i)])
    c00 = _decode(t00, tex.kind)
    c10 = _decode(t10, tex.kind)
    c01 = _decode(t01, tex.kind)
    c11 = _decode(t11, tex.kind)
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def sample(tex: TextureBuf, u, v, mode: int):
    """Sampler-mode dispatch (``w3e4.wgsl:196-216``): Nearest samples the
    nearest texel; Default behaves as the linear-filtered sampler, as does
    Bilinear (and None, whose sample the caller discards)."""
    if mode == TEX_NEAREST:
        return sample_nearest(tex, u, v)
    return sample_bilinear(tex, u, v)


def environment_map(tex: TextureBuf, direction):
    """Lat-long environment lookup: ``u = 0.5 * (1 + atan2(x, -z) / pi)``,
    ``v = acos(-y) / pi``, sampled at ``(u, 1 - v)`` (``w9e2.wgsl:234-246``;
    the flip makes v = 1 the zenith row of the stored image)."""
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    u = 0.5 * (1.0 + vec.div(vec.atan2(dx, -dz), math.pi))
    v = vec.div(vec.acos(torch.clamp(-dy, -1.0, 1.0)), math.pi)
    return sample_bilinear(tex, u, 1.0 - v)

"""Environment maps (port of ``tracer.render.texture``, the parts path mode
uses).

A texture is a plain (H, W, 4) float32 tensor with values in [0, 1]; an
RGBE map keeps the shared exponent in its raw alpha channel and is decoded
at sample time as rgb * 2^(a * 255 - 128) (``w9e2.wgsl:242-245``). The
lat-long lookup is ``environment_map`` (``w9e2.wgsl:234-246``). atan2, acos
and exp2 are taken in float64 and rounded, so the CPU and the card sample
the same texels with the same weights. Image loaders are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tracer_torch.math import vec

# Environment-map encodings
ENV_LDR = 1  # plain rgb (w9e1: jpg background)
ENV_RGBE = 2  # rgb * 2^(a*255 - 128)  (w9e2.wgsl:242-245)


@dataclass(frozen=True)
class TextureBuf:
    data: torch.Tensor  # (H, W, 4) f32 in [0, 1] (RGBE maps keep the raw alpha)
    kind: int = ENV_LDR


def _decode(texel, kind: int):
    rgb = texel[..., :3]
    if kind == ENV_RGBE:
        exponent = texel[..., 3] * 255.0 - 128.0
        rgb = rgb * vec.exp2(exponent)[..., None]
    return rgb


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
    c00 = _decode(tex.data[y0i, x0i], tex.kind)
    c10 = _decode(tex.data[y0i, x1i], tex.kind)
    c01 = _decode(tex.data[y1i, x0i], tex.kind)
    c11 = _decode(tex.data[y1i, x1i], tex.kind)
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def environment_map(tex: TextureBuf, direction):
    """Lat-long environment lookup: ``u = 0.5 * (1 + atan2(x, -z) / pi)``,
    ``v = acos(-y) / pi``, sampled at ``(u, 1 - v)`` (``w9e2.wgsl:234-246``;
    the flip makes v = 1 the zenith row of the stored image)."""
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    u = 0.5 * (1.0 + vec.div(vec.atan2(dx, -dz), math.pi))
    v = vec.div(vec.acos(torch.clamp(-dy, -1.0, 1.0)), math.pi)
    return sample_bilinear(tex, u, 1.0 - v)

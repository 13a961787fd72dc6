"""Vector math over trailing-axis-3 tensors (port of ``tracer.math.vec``).

Sums over the component axis are written out as ``(x + y) + z`` rather than
left to a reduction, so the rounding order is the same on every device and
matches the JAX package's sequential three-element reductions.
"""

from __future__ import annotations

import torch


def vec3(x, y, z):
    """Stack three (...,) components into a (..., 3) tensor."""
    return torch.stack([x, y, z], dim=-1)


def sum3(a):
    """Sum over the trailing axis of size 3, in the order (a0 + a1) + a2."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def dot(a, b, keepdims: bool = False):
    """Batched dot product over the trailing component axis."""
    out = sum3(a * b)
    return out[..., None] if keepdims else out


def cross(a, b):
    """Batched 3D cross product (trailing axis 3)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def sqrt(x):
    """Correctly rounded float32 square root on every device.

    PyTorch's float32 ``sqrt`` is not correctly rounded on every build (its
    vectorized CPU kernel misses the nearest float on about 2% of inputs),
    so the CPU and the card would disagree in the last bit. The float64
    root of a float32 input, rounded to float32, is the correctly rounded
    float32 root (53 >= 2 * 24 + 2 bits).
    """
    return torch.sqrt(x.double()).to(x.dtype)


def _via_f64(fn, *xs):
    """``fn`` evaluated in float64 on float32 inputs, rounded to float32: the
    same value on every device (PyTorch's float32 transcendentals differ
    between its CPU and CUDA kernels in the last bits)."""
    return fn(*(x.double() for x in xs)).to(xs[0].dtype)


def acos(x):
    return _via_f64(torch.acos, x)


def sin(x):
    return _via_f64(torch.sin, x)


def cos(x):
    return _via_f64(torch.cos, x)


def atan2(y, x):
    return _via_f64(torch.atan2, y, x)


def exp2(x):
    return _via_f64(torch.exp2, x)


def exp(x):
    return _via_f64(torch.exp, x)


def pow(x, y):
    return _via_f64(torch.pow, x, y)


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, g, -g)


def abs(x):
    """``|x|`` whose derivative at 0 is +1, as JAX's (PyTorch's is 0). The
    walls of a Cornell box are axis-aligned, so normals with a zero
    component are common and the choice shows in the gradients."""
    return _Abs.apply(x)


def length(a, keepdims: bool = False):
    return sqrt(dot(a, a, keepdims=keepdims))


def normalize(a, eps: float = 0.0):
    """Normalize over the trailing axis; ``eps=0`` matches WGSL
    ``normalize`` (inf/nan on zero vectors)."""
    n2 = dot(a, a, keepdims=True)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return a / sqrt(n2)


def reflect(d, n):
    """WGSL ``reflect``: ``d - 2*dot(d, n)*n`` (d points toward surface)."""
    return d - 2.0 * dot(d, n, keepdims=True) * n


def saturate(x):
    """WGSL ``saturate``: clamp to [0, 1]."""
    return torch.clamp(x, 0.0, 1.0)


def where(mask, a, b):
    """``torch.where`` with the mask broadcast over a trailing component axis."""
    return torch.where(mask[..., None], a, b)


_CONSTS: dict = {}


def const(value, dtype=torch.float32, device=None):
    """A tensor of the Python number or tuple ``value``, made once per
    (value, dtype, device) and shared by every caller, which only reads it.
    A fresh ``torch.tensor`` on a CUDA device is a blocking copy from the
    host (the host waits for the stream to drain), and inside a CUDA
    graph's capture it is an error. Keyed by ``repr``, so -0.0 and 0.0 stay
    apart; callers pass configuration constants, so the table stays
    small."""
    key = (repr(value), dtype, None if device is None else torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def div(a, c: float):
    """``a / c`` for a Python number ``c``, as a true division on every
    device: PyTorch's CUDA kernels multiply by the reciprocal when the
    divisor is a Python scalar, which can round differently from the CPU."""
    return a / const(c, a.dtype, a.device)


def mean3(a):
    """Mean over the component axis (sum, then divide by 3)."""
    return div(sum3(a), 3.0)

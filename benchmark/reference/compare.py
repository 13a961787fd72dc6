"""The numbers that decide ``correct``, each held to its limit.

A frame cell compares the program's progressive accumulator with the
reference's, pixel by pixel, at the pixels the cell checks:

* ``err_p50``: the median over the pixels where the reference sees the
  mesh (direct mode), or over every checked pixel (path mode), leaving out
  those the reference leaves black (a path that ends on the mesh without
  light), of the pixel's largest channel error, in units of the reference's mean
  absolute value over the checked pixels. Rounding of one order against
  another reads near 1e-7; a lower precision moves every pixel.
* ``bad_share``: the share of checked pixels whose error exceeds a
  hundredth of that scale: pixels that show something else (a frame
  skipped, a band not drawn, a different surface). A silhouette ray that
  grazes a triangle's edge may hit on one side and miss on the other, so
  a sound run reads a few such pixels.

A gradient cell compares the program's gradient with the reference's leaf
by leaf: ``grad_err`` is the largest, over the leaves, of the norm of the
difference over the reference leaf's norm. A leaf whose reference
gradient is zero to rounding, under ``ZERO_SHARE`` of the median leaf's
norm (the material's specular, shininess and ior, which the Lambertian
never reads, and leaves the reference does not model), is judged against
the median leaf's norm instead: the program's must be as near zero.
"""

from __future__ import annotations

import torch


ZERO_SHARE = 1e-3


def frame_numbers(prog, ref, judged) -> dict:
    """The frame cell's numbers: ``prog``, ``ref`` (M, 3) accumulators at
    the checked pixels; ``judged`` (M,) the pixels ``err_p50`` is taken
    over."""
    prog, ref = prog.double(), ref.double()
    scale = float(ref.abs().mean())
    scale = scale if scale > 0 else 1.0
    err = (prog - ref).abs().amax(dim=-1) / scale
    err = torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))
    judged = judged & (ref.abs().amax(dim=-1) > 0)
    sel = err[judged] if bool(judged.any()) else err
    return {
        "err_p50": float(sel.median()),
        "bad_share": float((err > 1e-2).double().mean()),
    }


def grad_numbers(prog: dict, ref: dict, leaves: dict | None = None) -> dict:
    """The gradient cell's number over the leaves of ``prog`` ({key:
    tensor}); a leaf the reference does not model must be zero.
    ``leaves``, where given, receives each leaf's reference norm and
    error."""
    norms, diffs = {}, {}
    for k, g in prog.items():
        r = ref.get(k)
        g = g.double()
        r = torch.zeros_like(g) if r is None else r.double().reshape(g.shape)
        norms[k] = float(r.norm())
        d = (g - r).norm()
        diffs[k] = float(d) if bool(torch.isfinite(d)) else float("inf")
    positive = sorted(n for n in norms.values() if n > 0)
    median = positive[len(positive) // 2] if positive else 1.0
    errs = {k: diffs[k] / (norms[k] if norms[k] >= ZERO_SHARE * median else median)
            for k in prog}
    if leaves is not None:
        leaves.update({k: {"norm": norms[k], "err": errs[k]} for k in prog})
    return {"grad_err": max(errs.values())}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out

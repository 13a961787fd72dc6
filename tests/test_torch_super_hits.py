"""The super-tile hits kernel's plain-PyTorch twin against the JAX package's
Pallas kernel (run in interpret mode on the CPU). The CUDA kernel is held
against the twin on the card in ``tests/test_torch_cuda.py``.

Inputs (``chip_smoke.synthetic``, which also feeds the kernel-vs-twin
checks on the card; numpy with a seed): 2 super-tiles of 2048 rays, 12
quarter blocks of 256 random triangles, 12 emission slots per super-tile
with zero gate words, ``en < K``, random (not near-ordered) entry
distances, random ray windows including dead (-3e38) ones, in both modes.
Both sides stream the same quarter blocks (assembled by the port).

Tolerance: ids (the best pid row, or the any-hit flag) must be equal, and
t is equal bitwise on lanes without a new hit. On hit lanes t cannot be held
to 1 ulp: XLA on the CPU always contracts a*b + c into one FMA, PyTorch
rounds both operations, and t = (k - n.o) / (n.d) cancels, so the two
differ by up to ~20 ulp on a few grazing lanes. t is held instead to the
first-order float32 error bound of that formula, evaluated per lane:
8 * 2^-24 * (|k| + |n_x o_x| + |n_y o_y| + |n_z o_z|) / |n.d|, plus
2 ulp of t.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic
from tracer.kernels import super_hits as jax_super_hits

from tracer_torch.kernels import super_hits


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_interpret(seed, any_hit):
    args = synthetic("cpu", any_hit, seed)
    tb, *arrays = args
    qblocks = tb.qblocks.numpy()  # both sides stream the very same blocks
    jtb = SimpleNamespace(T=tb.T, blocks=np.zeros((tb.NT, 1, 1), np.float32),
                          qblocks=jnp.asarray(qblocks), mxu=jnp.zeros((1, 1, 1)))
    jt, jp = jax_super_hits.hits2(jtb, *(jnp.asarray(a.numpy()) for a in arrays),
                                  any_hit, quarter=True)
    pt, pp = super_hits.hits2_reference(*args, any_hit)
    jt, jp = np.asarray(jt), np.asarray(jp)
    pt, pp = pt.numpy(), pp.numpy()
    o, d, _, best_t, best_pid = (a.numpy().reshape(-1, *a.shape[2:]) for a in arrays[4:])
    assert np.array_equal(jp, pp)
    if any_hit:
        assert (pp > 0).sum() > (best_pid > 0).sum()  # new occluders
        assert np.array_equal(pt, best_t.reshape(pt.shape))
    else:
        assert (pp >= 0).sum() > 500  # plenty of hits inside the windows
    _assert_t_close(jt.reshape(-1), pt.reshape(-1), jp.reshape(-1), qblocks, o, d)


def _assert_t_close(jt, pt, pid, qblocks, o, d):
    """t agrees bitwise where no triangle was hit, and within the float32
    error bound of the Möller t formula where one was."""
    hit = pid >= 0
    assert np.array_equal(jt[~hit], pt[~hit])
    feats = qblocks.transpose(0, 2, 1).reshape(-1, 16)
    feats = feats[feats[:, 10] > 0.5]
    row = np.full(int(feats[:, 9].max()) + 1, -1, np.int64)
    row[feats[:, 9].astype(np.int64)] = np.arange(feats.shape[0])
    f = feats[row[pid[hit].astype(np.int64)]].astype(np.float64)
    o = o[hit].astype(np.float64)
    d = d[hit].astype(np.float64)
    n, k = f[:, 11:14], f[:, 14]
    scale = np.abs(k) + np.abs(n * o).sum(-1)
    bound = 8 * 2.0 ** -24 * scale / np.abs((n * d).sum(-1))
    bound += 2 * np.spacing(np.abs(jt[hit])).astype(np.float64)
    err = np.abs(jt[hit].astype(np.float64) - pt[hit])
    assert (err <= bound).all(), (err / bound).max()


def test_wrapper_takes_the_twin_for_cpu_tensors():
    args = synthetic("cpu", False, 2)
    launches, calls = super_hits.KERNEL_LAUNCHES, super_hits.REFERENCE_CALLS
    t1, p1 = super_hits.hits2(*args, False)
    assert super_hits.KERNEL_LAUNCHES == launches
    assert super_hits.REFERENCE_CALLS == calls + 1
    t2, p2 = super_hits.hits2_reference(*args, False)
    assert torch.equal(t1, t2) and torch.equal(p1, p2)

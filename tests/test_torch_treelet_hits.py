"""The treelet hits kernel's plain-PyTorch twin (B3) against the JAX
package's Pallas kernel, run in interpret mode on the CPU. The CUDA kernel
is held against the twin on the card in ``tests/test_torch_cuda.py``.

Inputs (``chip_smoke.synthetic_tiles``, which also feeds the kernel-vs-twin
checks on the card; numpy with a seed): 3 treelets of 1024 random
triangles (the last partly empty), 6 tiles of 128 rays with 8 emission
slots each: ``en = 0``, ``en < K``, ids out of range, a dead tile (the
packet engine's padding), a non-zero ``enear`` that stops a tile's stream
after two blocks, and in any-hit mode pre-occluded lanes and a tile
occluded from the start. Both sides stream the very same blocks (assembled
by the port).

Tolerance: ids (the best pid row, or the any-hit flag) must be equal, and
t is equal bitwise where no triangle was hit. On hit lanes XLA on the CPU
contracts a*b + c into FMAs where PyTorch rounds both operations, so t is
held to the first-order float32 error bound of t = (k - n.o) / (n.d),
evaluated per lane (``test_torch_super_hits._assert_t_close``).
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores
from test_torch_super_hits import _assert_t_close

from chip_smoke import synthetic_tiles
from tracer.kernels import treelet_hits as jax_treelet_hits

from tracer_torch.accel.treelet import NQ, ROWS
from tracer_torch.kernels import treelet_hits

share_cores()


def _jax_blocks(tb):
    """The (NT, 16, T) block table of the JAX kernel from the quarters."""
    q = tb.qblocks.numpy().reshape(tb.NT, NQ, ROWS, tb.T // NQ)
    return q.transpose(0, 2, 1, 3).reshape(tb.NT, ROWS, tb.T)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_interpret(seed, any_hit):
    tb, eids, en, o, d, tmin, best_t, best_pid, enear = synthetic_tiles("cpu", any_hit, seed)
    jtb = SimpleNamespace(T=tb.T, blocks=jnp.asarray(_jax_blocks(tb)))
    j = lambda x: jnp.asarray(x.numpy())
    jt, jp = jax_treelet_hits.hits(jtb, j(eids), j(en), j(o), j(d), j(tmin), j(best_t),
                                   j(best_pid), any_hit, enear=j(enear))
    stats = {}
    pt, pp = treelet_hits.hits_reference(tb, eids, en, o, d, tmin, best_t, best_pid,
                                         any_hit, enear=enear, stats=stats)
    jt, jp, pt, pp = (np.asarray(x).reshape(-1) for x in (jt, jp, pt, pp))
    assert np.array_equal(jp, pp)
    # Visits: every slot below en, but the dead tile (window tops 0) stops
    # after its first block, tile 5 after two, and in any-hit mode the tile
    # occluded from the start after its first.
    assert stats["visits"] == 8 + 5 + 0 + (1 if any_hit else 8) + 1 + 2
    if any_hit:
        assert (pp > 0).sum() > (best_pid.numpy() > 0).sum()  # new occluders
        assert np.array_equal(pt, best_t.numpy().reshape(-1))
    else:
        assert (pp >= 0).sum() > 150  # plenty of hits inside the windows
        assert (pp[4 * 128:5 * 128] == -1).all()  # the dead tile
        assert (pp[2 * 128:3 * 128] == -1).all()  # en = 0
    qblocks = tb.qblocks.numpy()
    _assert_t_close(jt, pt, jp, qblocks, o.numpy().reshape(-1, 3), d.numpy().reshape(-1, 3))


def test_enear_break_changes_the_result():
    """The break is real: without the entry distances tile 5 streams all 8
    blocks and finds hits that the two-block stream does not."""
    tb, eids, en, o, d, tmin, best_t, best_pid, enear = synthetic_tiles("cpu", False, 0)
    _, p_break = treelet_hits.hits_reference(tb, eids, en, o, d, tmin, best_t, best_pid,
                                             False, enear=enear)
    _, p_all = treelet_hits.hits_reference(tb, eids, en, o, d, tmin, best_t, best_pid, False)
    assert not torch.equal(p_break[5], p_all[5])
    assert torch.equal(p_break[:5], p_all[:5])


def test_wrapper_takes_the_twin_for_cpu_tensors():
    args = synthetic_tiles("cpu", True, 2)
    tb, eids, en, o, d, tmin, best_t, best_pid, enear = args
    launches, calls = treelet_hits.KERNEL_LAUNCHES, treelet_hits.REFERENCE_CALLS
    t1, p1 = treelet_hits.hits(*args[:-1], True, enear=enear)
    assert treelet_hits.KERNEL_LAUNCHES == launches
    assert treelet_hits.REFERENCE_CALLS == calls + 1
    t2, p2 = treelet_hits.hits_reference(*args[:-1], True, enear=enear)
    assert torch.equal(t1, t2) and torch.equal(p1, p2)

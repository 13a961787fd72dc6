"""The treelet hits kernel's plain-PyTorch twin (B3) against the JAX
package's Pallas kernel, run in interpret mode on the CPU. The CUDA kernel
is held against the twin on the card in ``tests/test_torch_cuda.py``.

Inputs (``chip_smoke.synthetic_tiles``, which also feeds the kernel-vs-twin
checks on the card; numpy with a seed): 3 treelets of 1024 random
triangles (the last partly empty), 6 tiles of 128 rays with 8 emission
slots each: ``en = 0``, ``en < K``, ids out of range, a dead tile (the
packet engine's padding), a non-zero ``enear`` that stops a tile's stream
after two blocks, and in any-hit mode pre-occluded lanes and a tile
occluded from the start; and ``chip_smoke.lane_tiles`` for the live-lane
rule: tiles with 1, 31, 33 and 127 live lanes, a tile with emissions and no
live lane (some of its lanes at +inf), and lanes that die mid-stream in
both modes. Both sides stream the very same blocks (assembled by the
port).

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

from chip_smoke import lane_tiles, synthetic_tiles
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
    if not any_hit:  # every lane of tiles 0, 1, 3 and 5 is live, none of tile 4
        assert stats["live_tests"] == (8 + 5 + 8 + 2) * 128 * tb.T
        assert stats["idle_visits"] == 1
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


def _match_jax(args, any_hit):
    tb, eids, en, o, d, tmin, best_t, best_pid, enear = args
    jtb = SimpleNamespace(T=tb.T, blocks=jnp.asarray(_jax_blocks(tb)))
    j = lambda x: jnp.asarray(x.numpy())
    jt, jp = jax_treelet_hits.hits(jtb, j(eids), j(en), j(o), j(d), j(tmin), j(best_t),
                                   j(best_pid), any_hit, enear=j(enear))
    stats = {}
    pt, pp = treelet_hits.hits_reference(tb, eids, en, o, d, tmin, best_t, best_pid,
                                         any_hit, enear=enear, stats=stats)
    jt, jp = np.asarray(jt), np.asarray(jp)
    assert np.array_equal(jp.reshape(-1), pp.numpy().reshape(-1))
    if any_hit:  # the t row is the input's, passed through
        assert np.array_equal(jt.view(np.int32), pt.numpy().view(np.int32))
    else:
        _assert_t_close(jt.reshape(-1), pt.numpy().reshape(-1), jp.reshape(-1),
                        tb.qblocks.numpy(), o.numpy().reshape(-1, 3), d.numpy().reshape(-1, 3))
    return pt, pp, stats


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_live_lane_tiles_match_jax_interpret(seed, any_hit):
    """The live-lane cases give the JAX package's result; visits count
    every tile's slots below ``en``, dead tiles' included (no ``enear``
    break, as every tile keeps a lane with a positive bound); and the
    closest-mode live tests
    are counted by hand: 1, 31, 33 and 127 live lanes for 8, 5, 8 and 3
    blocks, none in tile 4, and tile 5's 128 lanes for 3 blocks, then 64
    once its axis lanes have died on the big triangle at t = tmin = 3."""
    args = lane_tiles("cpu", any_hit, seed)
    tb, best_t, best_pid = args[0], args[6], args[7]
    pt, pp, stats = _match_jax(args, any_hit)
    assert stats["visits"] == 8 + 5 + 8 + 3 + 8 + 8
    hand = (1 * 8 + 31 * 5 + 33 * 8 + 127 * 3 + 0 + 128 * 3 + 64 * 5) * tb.T
    if any_hit:
        assert 0 < stats["live_tests"] < hand  # lanes die at their first hit
        assert (pp[5, :64] == 1.0).all() and torch.equal(pt, best_t)
    else:
        assert stats["live_tests"] == hand and stats["idle_visits"] == 8
        assert (pt[5, :64] == 3.0).all() and (pp[5, :64] == 0.0).all()
        # Tile 4 has no live lane: unchanged, but for the +inf bounds that
        # the block's "no hit" update lowers to 3e38 (pid -1).
        assert torch.equal(pt[4, 16:], best_t[4, 16:]) and (pt[4, :16] == 3.0e38).all()
        assert torch.equal(pp[4], best_pid[4])
        for tile, n_live in enumerate((1, 31, 33, 127)):
            assert int((pp[tile] >= 0).sum()) <= n_live


def test_twin_skips_tiles_with_no_live_lane(monkeypatch):
    """The twin runs no Möller test for a tile with no live lane (tile 4 of
    ``lane_tiles``), and a tile's lanes are tested only while one is live."""
    args = lane_tiles("cpu", False, 0)
    tested = []
    moller = treelet_hits.moller_tile

    def spy(blk, rays, upper):
        tested.append(rays.shape[0])
        return moller(blk, rays, upper)

    monkeypatch.setattr(treelet_hits, "moller_tile", spy)
    stats = {}
    treelet_hits.hits_reference(*args[:-1], False, enear=args[-1], stats=stats)
    assert stats["idle_visits"] == 8
    assert sum(tested) == stats["visits"] - 8  # all but tile 4's 8 visits

"""The texture lookups' texel gradient: ``texture._GatherTexels`` and the
placement's twin ``kernels.texel_place.place_reference``, on the CPU.

* Forward: the Function's rows, and the bilinear and nearest samples made
  from them, equal the plain gathers ``tex.data[y, x]`` bit for bit, on an
  LDR and an RGBE map (a gather copies; nothing is rounded).
* Gradient: against autograd through the plain gathers. The cotangent rows
  reaching the gathers are the same on both sides; only the sum of each
  texel's rows is associated differently (the plain backward adds each
  tap's rows in lane order and then the four taps' tables; the placement
  adds the texel's rows of all taps in chunks of ``CHUNK_ROWS``, then the
  chunk partials). So each texel's difference is held to the float32 bound
  of two orders of one length-L sum, L * 2^-23 * sum |x| over its L rows,
  not to a fixed tolerance. Cases: every lane on one texel (the crowding of
  a path's first bounce, a segment over many chunks), taps that wrap
  around both edges, and an RGBE map whose alpha (exponent) channel gets a
  gradient.
* The twin sums in the stated order, bit for bit against a numpy sum of
  each chunk in stream order and then the partials in chunk order, at
  ``CHUNK_ROWS`` 32 and 256; a texel whose rows lie in one chunk sums as a
  plain sequential scatter-add does.
* With no gradient of the map wanted, the Function is not entered and the
  ``texel_place`` counters stay 0.

The kernel is held to the twin on the card in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from _share_cores import share_cores

from tracer_torch import obs
from tracer_torch.kernels import texel_place
from tracer_torch.render import texture

share_cores()

N = 20_000  # lanes a case


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.reset()


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _map(kind: int, seed: int, shape=(8, 16)) -> torch.Tensor:
    """(H, W, 4) float32 texels; an RGBE map's alpha keeps its exponent
    within 2^-8 .. 2^8, so decoded radiance and its gradient stay finite."""
    rs = np.random.RandomState(seed)
    data = rs.rand(*shape, 4).astype(np.float32)
    if kind == texture.ENV_RGBE:
        data[..., 3] = rs.randint(120, 137, shape) / np.float32(255.0)
    return torch.as_tensor(data)


def _uv(case: str, seed: int):
    rs = np.random.RandomState(seed)
    if case == "one texel":
        u, v = np.full(N, 0.3), np.full(N, 0.6)
    elif case == "wrap-around":
        # Within half a texel of the map's edges, and whole turns outside
        # [0, 1): both the left and right, top and bottom taps wrap.
        u = rs.choice([-1.0, 0.0, 1.0, 2.0], N) + rs.uniform(-0.03, 0.03, N)
        v = rs.choice([-1.0, 0.0, 1.0], N) + rs.uniform(-0.06, 0.06, N)
    else:
        u, v = rs.uniform(-1.0, 2.0, N), rs.uniform(-1.0, 2.0, N)
    return torch.as_tensor(u, dtype=torch.float32), torch.as_tensor(v, dtype=torch.float32)


def _plain_texels(tex, taps):
    return [tex.data[y, x] for y, x in taps]


SAMPLERS = {"bilinear": texture.sample_bilinear, "nearest": texture.sample_nearest}
KINDS = {"ldr": texture.ENV_LDR, "rgbe": texture.ENV_RGBE}


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("kind", KINDS)
def test_forward_is_bitwise_the_plain_gathers(kind, sampler, monkeypatch):
    data = _map(KINDS[kind], 1)
    u, v = _uv("spread", 2)
    taps = [(torch.randint(0, 8, (N,)), torch.randint(0, 16, (N,))) for _ in range(4)]
    leaf = data.clone().requires_grad_(True)
    rows = texture._texels(texture.TextureBuf(leaf, KINDS[kind]), taps)
    assert rows[0].grad_fn is not None  # through the Function
    for got, (y, x) in zip(rows, taps):
        assert torch.equal(_bits(got), _bits(data[y, x]))
    got = SAMPLERS[sampler](texture.TextureBuf(leaf, KINDS[kind]), u, v)
    monkeypatch.setattr(texture, "_texels", _plain_texels)
    want = SAMPLERS[sampler](texture.TextureBuf(data.clone().requires_grad_(True),
                                                KINDS[kind]), u, v)
    assert torch.equal(_bits(got), _bits(want))


def _grads(data, kind, sampler, u, v, g, monkeypatch):
    """(the placement's gradient, the placed streams, the plain gathers'
    gradient) of sum(sample * g)."""
    streams = []
    place = texel_place.place

    def spy(sids, rows, n):
        streams.append((sids, rows))
        return place(sids, rows, n)

    out = []
    with monkeypatch.context() as mp:
        mp.setattr(texel_place, "place", spy)
        leaf = data.clone().requires_grad_(True)
        (SAMPLERS[sampler](texture.TextureBuf(leaf, kind), u, v) * g).sum().backward()
        out.append(leaf.grad)
    with monkeypatch.context() as mp:
        mp.setattr(texture, "_texels", _plain_texels)
        leaf = data.clone().requires_grad_(True)
        (SAMPLERS[sampler](texture.TextureBuf(leaf, kind), u, v) * g).sum().backward()
        out.append(leaf.grad)
    return out[0], streams, out[1]


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("case,kind", [("one texel", "ldr"), ("wrap-around", "ldr"),
                                       ("spread", "rgbe"), ("one texel", "rgbe")])
def test_gradient_matches_the_plain_gathers(case, kind, sampler, monkeypatch):
    data = _map(KINDS[kind], 3)
    u, v = _uv(case, 4)
    g = torch.as_tensor(np.random.RandomState(5).standard_normal((N, 3)).astype(np.float32))
    got, streams, want = _grads(data, KINDS[kind], sampler, u, v, g, monkeypatch)
    taps = 4 if sampler == "bilinear" else 1
    assert len(streams) == 1 and streams[0][0].shape == (taps * N,)
    sids, rows = streams[0]
    assert torch.equal(sids, torch.sort(sids).values)
    n = data.shape[0] * data.shape[1]
    count = torch.bincount(sids.long(), minlength=n).double()[:, None]
    mag = torch.zeros((n, 4), dtype=torch.float64).index_add_(0, sids.long(), rows.double().abs())
    diff = (got.reshape(n, 4).double() - want.reshape(n, 4)).abs()
    assert bool((diff <= count * 2.0 ** -23 * mag).all()), float(diff.max())
    assert float(got.abs().sum()) > 0
    if case == "one texel":
        # Every lane's tap on one texel: a segment of N rows over many chunks.
        assert int(count.max()) == N > 10 * texel_place.CHUNK_ROWS
    if case == "wrap-around" and sampler == "bilinear":
        h, w = data.shape[:2]
        named = count.view(h, w) > 0
        assert named[0, 0] and named[0, w - 1] and named[h - 1, 0] and named[h - 1, w - 1]
    if kind == "rgbe":
        assert float(got[..., 3].abs().sum()) > 0  # the exponent's gradient
    else:
        assert not got[..., 3].any()  # an LDR map's alpha is never read


def _chunk_order_numpy(sids, rows, n, chunk):
    """The kernel's order in numpy: per-chunk ``np.add.at`` partials, then
    each texel's partials added in chunk order (only the chunks it has rows
    in)."""
    want = np.zeros((n, 4), np.float32)
    for a in range(0, sids.shape[0], chunk):
        part = np.zeros((n, 4), np.float32)
        np.add.at(part, sids[a:a + chunk], rows[a:a + chunk])
        touched = np.unique(sids[a:a + chunk])
        want[touched] = want[touched] + part[touched]
    return want


@pytest.mark.parametrize("chunk", [32, 256])
def test_place_reference_sums_in_chunk_order(chunk, monkeypatch):
    rs = np.random.RandomState(6)
    n = 2048
    # Bounce 1's crowding: most rows on a few texels, the rest spread.
    ids = np.concatenate([np.full(5000, 700), np.full(1300, 701), rs.randint(0, n, 3000)])
    sids = np.sort(ids).astype(np.int32)
    rows = (rs.standard_normal((sids.shape[0], 4))
            * rs.choice([1e-3, 1.0, 30.0], (sids.shape[0], 1))).astype(np.float32)
    monkeypatch.setattr(texel_place, "CHUNK_ROWS", chunk)
    calls, launches = texel_place.REFERENCE_CALLS, texel_place.KERNEL_LAUNCHES
    got = texel_place.place(torch.as_tensor(sids), torch.as_tensor(rows), n).numpy()
    assert texel_place.REFERENCE_CALLS == calls + 1 and texel_place.KERNEL_LAUNCHES == launches
    assert got.shape == (n, 4)
    assert np.array_equal(got.view(np.int32), _chunk_order_numpy(sids, rows, n, chunk)
                          .view(np.int32))
    seq = np.zeros((n, 4), np.float32)
    np.add.at(seq, sids, rows)
    chunk_of = np.arange(sids.shape[0]) // chunk
    inside = np.ones(n, bool)  # texels whose rows all lie in one chunk
    for j in np.unique(sids):
        inside[j] = np.unique(chunk_of[sids == j]).size == 1
    assert np.array_equal(got[inside].view(np.int32), seq[inside].view(np.int32))
    assert not got[np.bincount(sids, minlength=n) == 0].any()
    c = obs.counters()
    assert c["texel_place.rows"] == sids.shape[0] and c["texel_place.out_rows"] == n


def test_function_is_not_entered_without_a_map_gradient(monkeypatch):
    entered = []
    forward = texture._GatherTexels.forward
    monkeypatch.setattr(texture._GatherTexels, "forward",
                        staticmethod(lambda ctx, *a: entered.append(1) or forward(ctx, *a)))
    data = _map(texture.ENV_LDR, 7)
    u, v = _uv("spread", 8)
    # The map wants no gradient, the sample point does.
    uu = u.clone().requires_grad_(True)
    texture.sample_bilinear(texture.TextureBuf(data, texture.ENV_LDR), uu, v).sum().backward()
    assert uu.grad is not None
    # The map would, but no gradient is recorded.
    with torch.no_grad():
        texture.sample_bilinear(texture.TextureBuf(data.clone().requires_grad_(True),
                                                   texture.ENV_LDR), u, v)
    assert not entered
    assert obs.counters().get("texel_place.rows", 0) == 0
    assert obs.counters().get("texel_place.out_rows", 0) == 0
    # And with the map's gradient wanted it is entered, and counts.
    leaf = data.clone().requires_grad_(True)
    texture.sample_bilinear(texture.TextureBuf(leaf, texture.ENV_LDR), u, v).sum().backward()
    assert entered == [1] and obs.counters()["texel_place.rows"] == 4 * N

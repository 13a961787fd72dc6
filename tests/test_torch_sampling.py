"""Path mode's warps and the environment lookup against the JAX package, on
seeded normals, vectors, streams and directions (numpy, 200,000 each):
``onb.rotate_to_normal``, ``sampling.cosine_hemisphere`` and
``texture.environment_map`` on a seeded LDR and a seeded RGBE map.

Tolerances:
* ``rotate_to_normal``: bitwise (the same float32 operations; XLA keeps
  them apart on these shapes).
* ``cosine_hemisphere``: the advanced streams bitwise; the directions
  within 4 float32 ulps of 1 (4.8e-7): the port takes acos, sin and cos in
  float64 and rounds them, XLA's float32 approximations are off by an ulp
  or two, and the rotation carries that through.
* ``environment_map``: within 8e-6 of the largest decoded texel (measured
  3.5e-6 and 3.3e-6 of it): atan2 and acos differ by ulps, and a bilinear
  weight is the texture coordinate times the map's width (32 here), so an
  error of ~2^-24 in u moves a weight by ~2e-6 of the texels' spread.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _share_cores import share_cores

from chip_smoke import seeded_env
from tracer.math import onb as jax_onb
from tracer.math import sampling as jax_sampling
from tracer.render import texture as jax_texture

from tracer_torch.math import onb, sampling
from tracer_torch.render import texture

share_cores()

N = 200_000


def _unit(rs, n=N):
    x = rs.normal(size=(n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_rotate_to_normal_bitwise():
    rs = np.random.RandomState(0)
    nrm, v = _unit(rs), rs.normal(size=(N, 3)).astype(np.float32)
    want = np.asarray(jax_onb.rotate_to_normal(jnp.asarray(nrm), jnp.asarray(v)))
    got = onb.rotate_to_normal(torch.as_tensor(nrm), torch.as_tensor(v)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_cosine_hemisphere_matches_jax():
    rs = np.random.RandomState(1)
    nrm = _unit(rs)
    states = rs.randint(0, 1 << 32, N, dtype=np.uint64)
    jd, js = jax_sampling.cosine_hemisphere(jnp.asarray(nrm), jnp.asarray(states.astype(np.uint32)))
    td, ts = sampling.cosine_hemisphere(torch.as_tensor(nrm), torch.as_tensor(states.astype(np.int64)))
    assert np.array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=4 * 2.0 ** -23)
    assert ((td.numpy() * nrm).sum(-1) >= -1e-6).all()  # the upper hemisphere


@pytest.mark.parametrize("kind", [texture.ENV_LDR, texture.ENV_RGBE], ids=["ldr", "rgbe"])
def test_environment_map_matches_jax(kind):
    env = seeded_env(kind == texture.ENV_RGBE, seed=2 + kind, shape=(16, 32))
    d = _unit(np.random.RandomState(2 + kind))
    want = np.asarray(jax_texture.environment_map(
        jax_texture.TextureBuf(data=jnp.asarray(env), kind=kind), jnp.asarray(d)))
    got = texture.environment_map(
        texture.TextureBuf(data=torch.as_tensor(env), kind=kind), torch.as_tensor(d)).numpy()
    scale = float(np.abs(want).max())
    assert scale > (100.0 if kind == texture.ENV_RGBE else 0.9)
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-6 * scale)

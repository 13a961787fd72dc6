"""Direct-mode gradients on the meshless rows: ``grad_scene`` on W1 E1-E6,
W2 E1-E5 (W2 E5 also with the selections (4, 1): glossy and Phong, and
(7, 5): the transmit and the normal arm) and W3 E1, E2 and E4 at 32x32,
the W3 rows also under ``chip_smoke.seeded_texture`` on a plane that
``chip_smoke.with_textured_plane`` marks textured (``TEX_DEFAULT`` at
``uv_scale`` (1.5, 2), W3 E4 also ``TEX_NEAREST`` at (2, 2)), against the
JAX package's gradient on the very same buffers, by the checks of
``tests/_direct_grad.py`` (leaf by leaf under a mask of disputed pixels at
rtol 3e-4 and an atol of 1e-4 of the leaf's largest magnitude; the camera
and material leaves of the unmasked gradient at rtol 1e-3; two runs
bitwise). W3 E3 (16 sub-samples) has a module of its own,
``tests/test_torch_direct_grad_w3e3.py``.

* ``fd_check`` on every leaf class each row has (the base colours, the
  sphere's centre, the triangle's vertices, the camera eye; the texels and
  ``uv_scale`` on the textured plane), against a central difference of the
  port's own loss.
* The JAX package's gradient of W2 E5 under the selections (4, 1) is not
  finite at any size: the Phong lobe ``power(saturate(dot(w_o, w_r)),
  shininess)`` has shininess 0 on analytic primitives, and where the
  cosine is clamped to 0 ``jnp.power``'s derivative in its base is 0 x
  0^-1 = NaN (PyTorch's ``pow`` gives 0 there). The port's is finite. That
  case names the leaves (``NOT_FINITE_IN_JAX``) and is held to the JAX
  package on the others; ``fd_check`` holds the port's on all.
* A fault the port had: the plane's uv took ``torch.abs``,
  whose derivative at 0 is 0, where the JAX package's ``jnp.abs`` has +1;
  rays that land on the plane at u = 0 exactly now give the JAX package's
  gradient with respect to the plane's tangent and position.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _direct_grad import CASES, check_case, fd_probe, jax_sides, plane_u0_rays, port_scene
from _share_cores import share_cores

from tracer_torch.kernels.intersect import Rays
from tracer_torch.render import integrator
from tracer_torch.render import texture as tex

share_cores()

GROUPS = [
    ["W1 E1", "W1 E2", "W1 E3", "W1 E4", "W1 E5", "W1 E6"],
    ["W2 E1", "W2 E2", "W2 E3", "W2 E4", "W2 E5", "W2 E5 transparent+normal",
     "W2 E5 glossy+phong"],
    ["W3 E1", "W3 E2", "W3 E4", "W3 E1 texture", "W3 E2 texture", "W3 E4 texture",
     "W3 E4 nearest"],
]
# The leaves of the JAX package's gradient that are not finite (see the
# module docstring).
NOT_FINITE_IN_JAX = {"W2 E5 glossy+phong": (
    "camera.aspect", "camera.constant", "camera.eye", "camera.target", "camera.up",
    "planes.normal", "planes.position", "spheres.center", "spheres.ior", "spheres.radius")}
KEYS = [k for g in GROUPS for k in g]
BACKGROUND = ("W1 E1", "W1 E2", "W1 E3")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    try:
        return jax_sides(tmp_path_factory.mktemp("jax_direct_grad"), GROUPS)
    except RuntimeError as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("key", KEYS)
def test_gradient_matches_jax(jax_side, key):
    g = check_case(key, jax_side[key], NOT_FINITE_IN_JAX.get(key, ()))
    if key in BACKGROUND:
        assert not any(x.any() for x in g.values())
        return
    assert any(x.any() for x in g.values())
    texture = CASES[key][2]
    if texture is not None:
        assert np.abs(g["texture.data"]).sum() > 0
        # The nearest sampler is piecewise constant in uv.
        assert (np.abs(g["uniforms.uv_scale"]).sum() > 0) == (texture[0] != tex.TEX_NEAREST)


@pytest.mark.parametrize("key", [k for k in KEYS if k not in BACKGROUND])
def test_fd_check_each_leaf_class(jax_side, key):
    """``fd_check`` on the eye, the sphere's centre, the triangle's vertices
    and the base colours of the untextured cases; on the textured ones the
    texels, and ``uv_scale`` under the bilinear sampler. A random 16x16
    texture puts texel edges (kinks of the bilinear sampler, jumps of the
    nearest one) under many pixels, so there the geometry's and the nearest
    sampler's ``uv_scale`` difference quotients cross them; the JAX
    package's gradient holds those leaves instead."""
    scene, cfg = port_scene(jax_side[key])
    texture = CASES[key][2]
    if texture is None:
        keys = ("camera.eye", "spheres.center", "spheres.base_color", "planes.base_color",
                "tris.verts", "tris.base_color")
    else:
        keys = ("texture.data",) + (("uniforms.uv_scale",) if texture[0] != tex.TEX_NEAREST
                                    else ())
    for leaf_key in keys:
        fd_probe(scene, cfg, leaf_key)


def test_plane_uv_at_u_zero_matches_jax(jax_side):
    """``vec.abs`` in the plane's uv: its derivative at u = 0 is +1, as
    ``jnp.abs``'s (``torch.abs`` gave 0 there)."""
    scene, cfg = port_scene(jax_side["W3 E1"])
    o, d = (torch.as_tensor(x) for x in plane_u0_rays())
    n = o.shape[0]
    tangent = scene.planes.tangent.clone().requires_grad_()
    position = scene.planes.position.clone().requires_grad_()
    planes = dataclasses.replace(scene.planes, tangent=tangent, position=position)
    rays = Rays(o, d, torch.full((n,), cfg.eta), torch.full((n,), cfg.tmax))
    with torch.enable_grad():
        hit = integrator.trace_closest(dataclasses.replace(scene, planes=planes), cfg, rays)
        assert hit.valid.all() and (hit.uv[:, 0] == 0).all()
        got = torch.autograd.grad(hit.uv.sum(), (tangent, position))
    want_t, want_p = jax_side["plane u0"]
    assert np.abs(want_t).sum() > 0
    np.testing.assert_allclose(got[0].numpy(), want_t, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), want_p, rtol=1e-6)

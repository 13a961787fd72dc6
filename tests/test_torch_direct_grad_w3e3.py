"""Direct-mode gradients on ``W3 E3`` (16 stratified sub-samples) at 16x16
with ``chip_smoke.seeded_texture`` on the plane that
``chip_smoke.with_textured_plane`` marks textured (``TEX_DEFAULT``,
``uv_scale`` (1.5, 2)): every float leaf, the jitters, the texels and
``uv_scale`` included, against the JAX package's gradient on the very same
buffers, by the checks of ``tests/_direct_grad.py``; and ``fd_check`` on
the jitters and the texels.

A module of its own: the JAX package compiles the gradient of the 16
unrolled sub-samples for about a minute on one core, so its child
process runs beside the other modules' tests. Pixels with a texture
lookup within 1e-4 texels of a texel edge are masked
(``_direct_grad.TexelEdges``): which side of the bilinear kink such a
lookup takes turns on rounding, and the kink changes the lane's gradient.
"""

from __future__ import annotations

import dataclasses

import pytest
from _direct_grad import check_case, fd_probe, jax_sides, port_scene
from _share_cores import share_cores

share_cores()

KEY = "W3 E3 texture"


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    try:
        return jax_sides(tmp_path_factory.mktemp("jax_direct_grad_w3e3"), [[KEY]])[KEY]
    except RuntimeError as e:
        pytest.fail(str(e))


def test_gradient_matches_jax(jax_side):
    g = check_case(KEY, jax_side)
    for k in ("jitters", "texture.data", "uniforms.uv_scale", "camera.eye", "tris.verts"):
        assert abs(g[k]).sum() > 0, k


@pytest.mark.parametrize("leaf_key", ["jitters", "texture.data", "tris.base_color"])
def test_fd_check(jax_side, leaf_key):
    """The jitters are probed on the plane's base colour (the scene without
    the texture): shifting every sub-sample moves the far plane's lookups
    across many texels of a random texture, whose kinks no derivative
    sees."""
    scene, cfg = port_scene(jax_side)
    if leaf_key == "jitters":
        scene = dataclasses.replace(scene, texture=None)
    fd_probe(scene, cfg, leaf_key)

"""Direct-mode gradients on the mesh rows: ``grad_scene`` on the Cornell
rows (``W5 E4``/``E5``, ``W6 E2``/``E3``, ``W7 E1``/``E2``, from
``chip_smoke.with_fixture_model``; brute force, one-hot row fetches) at
16x16, on ``W6 E1 Bunny`` (the ``mix_ka`` ambient; the flat engine, B1's
twin forward and B2's twin backward) and on ``W5 E2`` and ``W5 E3`` on the
bunny stand-in (``chip_smoke.with_standin_mesh``: the ``directional``
light with shadow rays, the flat engine's any-hit) at 32x24, against the
JAX package's gradient on the very same buffers, by the checks of
``tests/_direct_grad.py``.

* ``W6 E2`` (eta 1e-5): its area-light shadow rays start within float32
  noise of their own surface, so rounding decides the acne on most lit
  lanes in both packages. Those pixels are disputed and masked, as the
  frame test masks them.
* ``W6 E3``: the JAX package's gradient is not finite at any size (its
  glossy sphere's Phong lobe has shininess 0, and ``jnp.power``'s
  derivative in its base at a clamped cosine of 0 is 0 x 0^-1); the test
  names those leaves (``NOT_FINITE_IN_JAX``) and holds the others, and
  ``fd_check`` holds the port's.
* ``fd_check`` on each leaf class a row has: the diffuse albedo, the
  camera eye, the vertices (a rigid translation), the spheres' centre
  (see ``test_fd_check_each_leaf_class``).
* The teapot rows raise ``FileNotFoundError`` before any gradient work.
"""

from __future__ import annotations

import pytest
import torch
from _direct_grad import check_case, fd_probe, jax_sides, port_scene
from _share_cores import share_cores

from tracer_torch.diff import grad as G

share_cores()

CORNELL = ["W5 E4 Cornell Box", "W5 E5 Cornell Box", "W6 E2 Cornell Box", "W6 E3 Cornell Box",
           "W7 E1 Cornell Box", "W7 E2 Cornell Box"]
# One child per case that reaches the flat engine (ROADMAP §C).
GROUPS = [CORNELL, ["W6 E1 Bunny"], ["W5 E2 bunny"], ["W5 E3 bunny"]]
KEYS = [k for g in GROUPS for k in g]
NOT_FINITE_IN_JAX = {"W6 E3 Cornell Box": (
    "camera.aspect", "camera.constant", "camera.eye", "camera.target", "camera.up",
    "geom.vertices", "spheres.center", "spheres.ior", "spheres.radius")}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    try:
        return jax_sides(tmp_path_factory.mktemp("jax_direct_grad_mesh"), GROUPS)
    except RuntimeError as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("key", KEYS)
def test_gradient_matches_jax(jax_side, key):
    g = check_case(key, jax_side[key], NOT_FINITE_IN_JAX.get(key, ()))
    assert any(x.any() for x in g.values())


def _axis(x, index, axis):
    d = torch.zeros_like(x)
    d[index, axis] = 1.0
    return d


@pytest.mark.parametrize("key", KEYS)
def test_fd_check_each_leaf_class(jax_side, key):
    """The albedo, the vertices, the eye and the spheres' centre.

    On the Cornell rows, against the target ``clip(0.9 * radiance, 0, 10)``
    (``tests/test_grad.py``'s): the albedo along 0.01 at eps 3e-2 and rtol
    0.15 (that test's probe); the light quad's vertices moved down at eps
    0.1, the eye along x at eps 5e-3 and the glossy sphere along y at eps
    0.05 (W6 E3), each at rtol 0.08. A rigid translation of the whole box
    moves its lights with it and changes the frame by less than the loss's
    rounding, and a step of 0.5 along the eye flips silhouette pixels of
    the 16x16 frame. W6 E2 gets the albedo alone: its acne flips shadow
    rays under any move of the geometry or the eye.

    On the bunny (target zeros): the albedo at eps 1e-2 and rtol 1e-3, and
    the vertices' z-translation and the eye along z at eps 1e-3 of the
    mesh's extent and rtol 0.25 and 0.3 (``tests/test_torch_grad.py``'s).
    The shadowed stand-ins (W5 E2/E3) are almost wholly in shadow, so any
    move of the geometry flips which lanes are: only their albedo is
    probed."""
    scene, cfg = port_scene(jax_side[key])
    if "Cornell" in key:
        with torch.no_grad():
            target = torch.clamp(G.render_radiance(scene, cfg) * 0.9, 0.0, 10.0)
        d = scene.materials.diffuse
        fd_probe(scene, cfg, "materials.diffuse", 3e-2, 0.15, torch.ones_like(d) * 0.01, target)
        if key == "W6 E2 Cornell Box":
            return
        verts = scene.geom.vertices
        light = torch.zeros_like(verts)
        light[scene.geom.indices[scene.light_indices.long()].long().flatten(), 1] = -1.0
        fd_probe(scene, cfg, "geom.vertices", 0.1, 0.08, light, target)
        fd_probe(scene, cfg, "camera.eye", 5e-3, 0.08, torch.tensor([1.0, 0.0, 0.0]), target)
        if scene.spheres is not None:
            fd_probe(scene, cfg, "spheres.center", 0.05, 0.08, _axis(scene.spheres.center, 1, 1),
                     target)
        return
    fd_probe(scene, cfg, "materials.diffuse", 1e-2, 1e-3)
    if key == "W6 E1 Bunny":
        verts = scene.geom.vertices
        extent = float((verts.max(dim=0).values - verts.min(dim=0).values).max())
        fd_probe(scene, cfg, "geom.vertices", 1e-3 * extent, 0.25, _axis(verts, slice(None), 2))
        fd_probe(scene, cfg, "camera.eye", 1e-3 * extent, 0.3, torch.tensor([0.0, 0.0, 1.0]))


@pytest.mark.parametrize("row", ["W6 E1 Teapot", "W5 E2 Teapot", "Project: Utah Teapot BSP"])
def test_teapot_rows_raise_before_any_gradient_work(row):
    """The teapot is missing and has no stand-in: its rows raise
    ``FileNotFoundError`` at the build, before any gradient work, as their
    frames do (and as the JAX package's do)."""
    from tracer_torch.scenes.build import build_scene
    from tracer_torch.scenes.registry import get_scene

    with pytest.raises(FileNotFoundError):
        build_scene(get_scene(row), "cpu")

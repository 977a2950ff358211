"""The mesh slice as a whole: the port's ``make_renderer`` against the JAX
package's on an opaque triangle scene, with the JAX uniforms injected
(``JaxKeySampler`` of tests/test_torch_render.py), and the mesh stand-in
scene through both loaders.

The scene is the opaque 600-triangle soup of tests/test_accel.py with a
mirror sphere, reflective triangles and a checkered back wall, lit by a
sphere emitter (or by one of the triangles), so chains live past round 0.
The camera's fov is 55°: there ``jnp.tan`` of the half angle is the
rounded tangent, as torch's is, so both packages shoot bit-identical
primary rays (at 60° XLA's tangent is an ulp off, and an ulp in a ray's
direction flips the side of a grazing triangle hit, and with it
``is_outside``).  Routes: the
cluster sweep (auto, 600 >= 512 triangles) with shared-origin shortlist
shadows, the dense triangle route (``accel="none"``) and the per-ray
cluster shadow sweep (``shadow_mode="per_ray"``, at a visit budget of 4
so that both truncation guards report spill).

The JAX frame runs op by op (``jax.disable_jit``, ``remat=False``):
compiled, XLA contracts multiply-adds into FMAs (see test_torch_render).
Tolerances: ray counts and both spill maxima exact; z equal zero pattern
and rtol 1e-6; image max abs diff <= 1e-5 · image max.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import make_renderer as jax_make_renderer
from c_raytracer_tpu.scene import load_scene as jax_load_scene
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import load_scene
from test_torch_render import EXACT_STATS, JaxKeySampler

pytest_plugins = ("torch_harness",)

MESH_SCENE = os.path.join(os.path.dirname(__file__), "..", "scenes",
                          "meshes_opaque.json")
SPILLS = ("shadow_spill_max", "visit_spill_max")


def lit_soup(triangle_emitter=False, nt=600):
    """The opaque soup, Morton-ordered by the JAX package, with an emitter
    and reflective materials."""
    rng = np.random.default_rng(0)
    tv = rng.uniform(-3, 3, (nt, 3, 3)).astype(np.float32)
    tv[:, 1:] = tv[:, :1] + rng.uniform(-0.4, 0.4, (nt, 2, 3)).astype(
        np.float32)
    lights = [0] * nt
    mats = [0] * nt
    if triangle_emitter:
        tv[-1] = [[-1, 5, -2], [1, 5, -2], [0, 5, -4]]
        lights[-1], mats[-1] = 16, 2
    sc = jax_make_scene(
        sphere_center=[[0.0, 0.0, 0.0], [0.0, 6.0, -3.0]],
        sphere_radius=[0.5, 0.5], sphere_material=[1, 2],
        sphere_lights=[0, 0 if triangle_emitter else 16],
        tri_vertices=tv, tri_material=mats, tri_lights=lights,
        plane_point=[[0, 0, 6]], plane_normal=[[0, 0, -1]],
        plane_material=[3],
        materials=[
            dict(ks=[0.6, 0.6, 0.6], ka=[.1, .1, .1], kr=[.3, .3, .3],
                 shininess=16, tex_color=[0.8, 0.5, 0.3]),
            dict(ks=[1, 1, 1], ka=[.05] * 3, kr=[.7, .7, .7],
                 shininess=64, tex_color=[1, 1, 1]),
            dict(ke=[30, 30, 28], tex_color=[1, 1, 1]),
            dict(ks=[.2] * 3, ka=[.2] * 3, tex_type=1,
                 tex_color=[.9, .9, .9], tex_color2=[.1, .1, .2],
                 tex_scale=1.3),
        ],
        camera=dict(position=[0, 0, -8], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=55, focal_length=1))
    return jax_reorder(sc)


def _compare(sc, kw, res):
    resx, resy = res
    kw = dict(max_bounces=2, tile_size=128, **kw)
    n_tiles = -(-(resx * resy) // 128)
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        j_img, j_z, j_st = jax_make_renderer(
            sc.static, JaxConfig(remat=False, **kw), resx, resy, jit=False,
            with_stats=True)(sc.params, key)
    fn = make_renderer(sc.static, RenderConfig(**kw), resx, resy,
                       device="cpu", with_stats=True)
    img, z, st = fn(sc.params, JaxKeySampler(key, n_tiles))

    j_img, j_z = np.asarray(j_img), np.asarray(j_z)
    img, z = img.numpy(), z.numpy()
    assert img.shape == j_img.shape == (resy, resx, 3)
    for k in EXACT_STATS + SPILLS:
        assert float(st[k]) == float(j_st[k]), k
    np.testing.assert_array_equal(z == 0, j_z == 0)
    np.testing.assert_allclose(z, j_z, rtol=1e-6, atol=0)
    assert np.all(np.isfinite(img)) and j_img.max() > 0
    assert np.abs(img - j_img).max() <= 1e-5 * j_img.max()
    return st


@pytest.mark.parametrize("case", ["cluster_auto", "dense", "per_ray",
                                  "triangle_emitter"])
def test_mesh_render_matches_jax(case):
    sc = lit_soup(triangle_emitter=case == "triangle_emitter")
    # per_ray with 4 visits: both truncation guards fire, as in JAX
    kw = {"dense": dict(accel="none"),
          "per_ray": dict(shadow_mode="per_ray", bvh_visits=4)}.get(case, {})
    # 16x12 = 192 px: two tiles, the last one padded
    st = _compare(sc, kw, (16, 12) if case == "cluster_auto" else (16, 16))
    assert float(st["children_pushed"]) > 0           # chains past round 0
    assert float(st["shadow_rays"]) > 0
    if case == "per_ray":
        assert float(st["visit_spill_max"]) > 0
        assert float(st["shadow_spill_max"]) > 0


def test_stand_in_loads_same_in_both_loaders():
    """scenes/meshes_opaque.json: the port's loader and reorder_scene give
    the JAX package's Morton-ordered scene, with its meshes resolved from
    assets/meshes."""
    a = reorder_scene(load_scene(MESH_SCENE))
    b = jax_reorder(jax_load_scene(MESH_SCENE))
    assert dataclasses.asdict(a.static) == dataclasses.asdict(b.static)
    np.testing.assert_array_equal(a.params.tri_vertices,
                                  np.asarray(b.params.tri_vertices))
    st = a.static
    assert (st.n_spheres, st.n_triangles, st.n_planes) == (2, 136896, 1)
    assert not any(st.is_transparent)
    assert st.emitter_prims == (1,) and st.num_lights[1] == 200

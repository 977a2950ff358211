"""Primary rays and the dense closest-hit fold of the port against the JAX
package's, on the same NumPy inputs."""

import jax
import numpy as np
import pytest
import torch

from c_raytracer_tpu.core import v3 as jv3
from c_raytracer_tpu.geometry import primitives as JG
from c_raytracer_tpu.render.camera import primary_rays as jax_primary_rays
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.core import v3 as tv3
from c_raytracer_tpu_torch.geometry import primitives as TG
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.scene import params_to_torch


def _scene(seed):
    r = np.random.default_rng(seed)
    mats = [dict(ks=[0.5] * 3, tex_type=0, tex_color=[1, 0, 0]),
            dict(ks=[0.2] * 3, tex_type=0, tex_color=[0, 1, 0]),
            dict(ke=[5, 5, 5], tex_type=0, tex_color=[1, 1, 1])]
    cam = dict(position=[0.3, 1.1, -6.0], vector_x=[1, 0.05, 0],
               vector_y=[0, 1, 0.1], fov=float(r.uniform(30, 90)),
               focal_length=float(r.uniform(0.5, 2)))
    return jax_make_scene(
        sphere_center=r.normal(size=(4, 3)) * 2,
        sphere_radius=r.uniform(0.3, 1.2, size=4),
        sphere_material=[0, 1, 0, 2], sphere_lights=[0, 0, 0, 16],
        plane_point=[[0, -2, 0], [0, 0, 9]],
        plane_normal=[[0, 1, 0.1], [0.2, 0, -1]], plane_material=[1, 0],
        materials=mats, camera=cam)


@pytest.mark.parametrize("seed,res", [(0, (32, 32)), (1, (24, 20)),
                                      (2, (7, 13))])
def test_primary_rays_match_jax(seed, res):
    sc = _scene(seed)
    jo, jd = jax_primary_rays(sc.params.camera, *res)
    o, d = primary_rays(params_to_torch(sc.params, "cpu").camera, *res)
    assert o.shape == d.shape == (res[0] * res[1], 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closest_hit_matches_jax(seed):
    sc = _scene(seed)
    r = np.random.default_rng(100 + seed)
    n = 4096
    o = r.normal(size=(n, 3)).astype(np.float32) * 3
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    jds = JG.device_scene(sc.params, sc.static)
    jt, jg, jm, jn = JG.closest_hit_soa(jds, sc.static, jv3.from_aos(o),
                                        jv3.from_aos(d))
    tds = TG.device_scene(params_to_torch(sc.params, "cpu"), sc.static)
    t, g, m, nrm = TG.closest_hit_soa(
        tds, sc.static, tv3.from_aos(torch.from_numpy(o)),
        tv3.from_aos(torch.from_numpy(d)))

    jg = np.asarray(jg)
    assert (jg >= 0).mean() > 0.3 and (jg < 0).any()  # hits and misses
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5)
    np.testing.assert_allclose(tv3.to_aos(nrm).numpy(),
                               np.asarray(jv3.to_aos(jn)), atol=1e-5)


def test_device_scene_refuses_triangles():
    """Triangles were refused until the mesh slice; now device_scene builds
    their tables (edges, normals, epsilons) as the JAX package does."""
    sc = jax_make_scene(
        tri_vertices=[[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                      [[0, 0, 1], [2, 0, 1], [0, 3, 2]]], tri_material=[0, 0],
        sphere_center=[[0, 3, 0]], sphere_radius=[1.0], sphere_material=[0],
        plane_point=[[0, -1, 0]], plane_normal=[[0, 1, 0]],
        plane_material=[0],
        materials=[dict(ke=[1, 1, 1], tex_type=0)],
        camera=dict(position=[0, 0, -5], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=60, focal_length=1))
    with jax.disable_jit():          # jitted, jnp.cross contracts into FMAs
        jds = JG.device_scene(sc.params, sc.static)
    tds = TG.device_scene(params_to_torch(sc.params, "cpu"), sc.static)
    for name in ("tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_eps", "sph_eps",
                 "pln_eps", "prim_eps", "mat_idx"):
        np.testing.assert_array_equal(getattr(tds, name).numpy(),
                                      np.asarray(getattr(jds, name)),
                                      err_msg=name)

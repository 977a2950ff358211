"""The stack integrator on the cluster route: the port's ``make_renderer``
against the JAX package's on a transparent triangle soup, with the JAX
uniforms injected (``JaxKeySampler`` of tests/test_torch_render.py).

The scene is the 600-triangle soup of tests/test_accel.py in a glass
material (kt 0.5/0.6/0.7, ior 1.3, a little mirror), with a mirror sphere,
a checkered back wall and a sphere emitter; fov 55° (see
tests/test_torch_mesh_render.py).  600 >= 512 triangles take the cluster
sweep, and a transparent scene's auto shadow mode is "union" (over
64-triangle shadow clusters, 192 slots); "per_ray" is the opt-in.

The JAX frame runs op by op (``jax.disable_jit``, ``remat=False``); the
per-ray and small-stack cases run from tests/test_torch_union_modes.py, so
that each file takes about a minute alone on the CPU.
Tolerances (``compare_frames``): every ray count, the drops and both spill
maxima exact; z equal zero pattern and rtol 1e-6; image within 1e-3 · its
max everywhere and within 1e-5 · max on >= 99% of pixels.  The share
allows a few pixels whose refracted rays moved by an ulp: arccos, arcsin,
sin and cos round differently in XLA and in torch, and a light sample
grazing a silhouette can then flip (one sample of 100 changes a pixel by
~1e-4 of the frame's max).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import make_renderer as jax_make_renderer
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import make_scene
from test_torch_render import EXACT_STATS, JaxKeySampler

STACK_STATS = EXACT_STATS + ("dropped", "shadow_spill_max", "visit_spill_max")


def glass_soup_kwargs(nt=600):
    rng = np.random.default_rng(0)
    tv = rng.uniform(-3, 3, (nt, 3, 3)).astype(np.float32)
    tv[:, 1:] = tv[:, :1] + rng.uniform(-0.4, 0.4, (nt, 2, 3)).astype(
        np.float32)
    return dict(
        sphere_center=[[0.0, 0.0, 0.0], [0.0, 6.0, -3.0]],
        sphere_radius=[0.5, 0.5], sphere_material=[1, 2],
        sphere_lights=[0, 16],
        tri_vertices=tv, tri_material=[0] * nt,
        plane_point=[[0, 0, 6]], plane_normal=[[0, 0, -1]],
        plane_material=[3],
        materials=[
            dict(ks=[0.6] * 3, ka=[.1] * 3, kr=[.2] * 3, kt=[.5, .6, .7],
                 refractive_index=1.3, shininess=16,
                 tex_color=[0.8, 0.5, 0.3]),
            dict(ks=[1, 1, 1], ka=[.05] * 3, kr=[.7] * 3, shininess=64,
                 tex_color=[1, 1, 1]),
            dict(ke=[30, 30, 28], tex_color=[1, 1, 1]),
            dict(ks=[.2] * 3, ka=[.2] * 3, tex_type=1,
                 tex_color=[.9, .9, .9], tex_color2=[.1, .1, .2],
                 tex_scale=1.3),
        ],
        camera=dict(position=[0, 0, -8], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=55, focal_length=1))


@functools.lru_cache(maxsize=None)
def glass_soup():
    """(JAX scene, port scene) of the glass soup, both Morton-ordered."""
    kw = glass_soup_kwargs()
    return jax_reorder(jax_make_scene(**kw)), reorder_scene(make_scene(**kw))


def compare_frames(jax_scene, scene, kw, res, seed, stats=STACK_STATS,
                   port_kw=None, share=0.99):
    """Render with both packages (JAX op by op, its uniforms injected) and
    hold the port to the module's tolerances, with ``share`` of the pixels
    within 1e-5 · max; ``port_kw`` overrides ``kw`` in the port's config.
    Returns the port's stats."""
    resx, resy = res
    tile = kw.get("tile_size") or 2048
    key = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        j_img, j_z, j_st = jax_make_renderer(
            jax_scene.static, JaxConfig(remat=False, **kw), resx, resy,
            jit=False, with_stats=True)(jax_scene.params, key)
    fn = make_renderer(scene.static, RenderConfig(**{**kw, **(port_kw or {})}),
                       resx, resy, device="cpu", with_stats=True)
    img, z, st = fn(scene.params,
                    JaxKeySampler(key, -(-(resx * resy) // tile)))
    j_img, j_z = np.asarray(j_img), np.asarray(j_z)
    img, z = img.numpy(), z.numpy()
    assert img.shape == j_img.shape == (resy, resx, 3)
    for k in stats:
        assert float(st[k]) == float(j_st[k]), k
    np.testing.assert_array_equal(z == 0, j_z == 0)
    np.testing.assert_allclose(z, j_z, rtol=1e-6, atol=0)
    assert np.all(np.isfinite(img)) and j_img.max() > 0
    diff = np.abs(img - j_img).max(-1)
    assert diff.max() <= 1e-3 * j_img.max()
    assert (diff <= 1e-5 * j_img.max()).mean() >= share
    return st


def check_glass_soup(mode):
    """16x16, 2 bounces: union shadows (the auto), per-ray shadows, and a
    stack of 2 slots, where a ray inside one glass triangle that hits
    another pushes two children onto a full stack: both packages drop and
    count the same ones."""
    jsc, sc = glass_soup()
    kw = dict(max_bounces=2, light_chunk=8)
    if mode == "per_ray":
        kw["shadow_mode"] = "per_ray"
    if mode == "stack_of_2":
        kw["stack_size"] = 2
    st = compare_frames(jsc, sc, kw, (16, 16), 11)
    assert float(st["children_pushed"]) > 0
    assert float(st["main_rays"]) > 256        # refraction children traced
    assert (float(st["dropped"]) > 0) == (mode == "stack_of_2")


@pytest.mark.parametrize("mode", ["union"])
def test_glass_soup_matches_jax(mode):
    check_glass_soup(mode)


def test_union_options_render_the_same_frame():
    """Frame and chunk scope, pixel compaction on and off, per-ray and
    dense shadows: the same image, bit for bit, and the same stats; a
    starved union budget reports its spill."""
    _, sc = glass_soup()
    frames = {}
    for name, kw in {
            "frame": {}, "chunk": dict(union_scope="chunk"),
            "compact_on": dict(union_compact="on"),
            "compact_off": dict(union_compact="off"),
            "per_ray": dict(shadow_mode="per_ray"),
            "dense": dict(accel="none"),
            "starved": dict(bvh_shadow_visits=2)}.items():
        fn = make_renderer(sc.static, RenderConfig(
            max_bounces=2, light_chunk=8, **kw), 16, 16, device="cpu",
            with_stats=True)
        img, _, st = fn(sc.params, PhiloxSampler(3, "cpu"))
        frames[name] = (img, {k: float(v) for k, v in st.items()})
    ref_img, ref_st = frames["frame"]
    assert ref_st["shadow_spill_max"] == 0
    for name in ("chunk", "compact_on", "compact_off", "per_ray", "dense"):
        img, st = frames[name]
        assert torch.equal(img, ref_img), name
        assert st == ref_st, name
    assert frames["starved"][1]["shadow_spill_max"] > 0

"""The stack integrator on the dense route: the port's ``make_renderer``
against the JAX package's on ``scenes/example.json`` (three spheres, one
of them glass, a triangle and the checkerboard plane), with the JAX
uniforms injected, at the tolerances of tests/test_torch_union_render.py
(which also holds the stack's overflow drops); which integrator a scene
takes; and the glass stand-in scene through both loaders.
"""

import dataclasses
import os

import numpy as np
import pytest

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.scene import load_scene as jax_load_scene
from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, integrator
from c_raytracer_tpu_torch.render import make_renderer
from c_raytracer_tpu_torch.scene import load_scene
from test_torch_union_render import compare_frames

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
EXAMPLE = os.path.join(SCENES, "example.json")
GLASS = os.path.join(SCENES, "meshes_glass.json")


@pytest.fixture(scope="module")
def example():
    """(JAX scene, port scene) of scenes/example.json."""
    return jax_load_scene(EXAMPLE), load_scene(EXAMPLE)


@pytest.mark.parametrize("case", ["phong_sqr_b3", "blinn_lin_b2"])
def test_example_matches_jax(case, example):
    """16x16 of example.json: 3 bounces, Phong and sqr attenuation; 2
    bounces, Blinn and lin."""
    jsc, sc = example
    kw = (dict(max_bounces=3) if case == "phong_sqr_b3" else
          dict(max_bounces=2, reflection_model="blinn",
               light_attenuation="lin"))
    st = compare_frames(jsc, sc, kw, (16, 16), 7)
    assert float(st["children_pushed"]) > 0
    assert float(st["dropped"]) == 0


def test_transparent_scenes_take_the_stack(example, monkeypatch):
    """``render_wavefront`` takes the stack integrator exactly when a
    material is transparent."""
    _, sc = example
    calls = []
    for name in ("_render_stack", "_render_chain"):
        real = getattr(integrator, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(integrator, name, spy)
    opaque = dataclasses.replace(
        sc.params, materials=dataclasses.replace(
            sc.params.materials,
            kt=np.zeros_like(sc.params.materials.kt)))
    cfg = RenderConfig(max_bounces=1)
    for static, params in ((sc.static, sc.params),
                           (dataclasses.replace(
                               sc.static, is_transparent=tuple(
                                   False for _ in sc.static.is_transparent)),
                            opaque)):
        make_renderer(static, cfg, 4, 4, device="cpu")(
            params, PhiloxSampler(0, "cpu"))
    assert calls == ["_render_stack", "_render_chain"]


def test_glass_stand_in_loads_same_in_both_loaders():
    """scenes/meshes_glass.json: the dragon of assets/meshes in the glass
    material of example.json, Morton-ordered alike by both packages."""
    a = reorder_scene(load_scene(GLASS))
    b = jax_reorder(jax_load_scene(GLASS))
    assert dataclasses.asdict(a.static) == dataclasses.asdict(b.static)
    np.testing.assert_array_equal(a.params.tri_vertices,
                                  np.asarray(b.params.tri_vertices))
    st = a.static
    assert (st.n_spheres, st.n_triangles, st.n_planes) == (2, 100800, 1)
    assert st.is_transparent == (False, False, False, True)
    assert st.emitter_prims == (1,) and st.num_lights[1] == 100
    np.testing.assert_array_equal(a.params.materials.kt[3],
                                  np.float32([0.85, 0.85, 0.9]))

"""Gradients of the stack integrator (transparent scenes): the port's
``make_renderer`` under ``loss.backward()`` against ``jax.grad`` of the
JAX package's renderer run op by op, with the loss, the injected JAX
uniforms and the tolerances of tests/test_torch_grad.py: every leaf within
1e-4 · max|g_jax| of its own scale, remat on equal to remat off bit for
bit, and no occlusion query in the backward (the blocker counts that form
the kt tint are kept from the forward).

Cases: scenes/example.json on the dense route (a glass sphere beside two
opaque spheres, a triangle and the checkerboard plane; 8 light samples,
2 bounces); the glass soup of tests/test_torch_union_render.py cut to 128
triangles on the cluster route, with union shadows (the transparent auto)
over 32-triangle shadow clusters, 8 light samples and 1 bounce.  Nearly all
of each case's minute on the CPU is JAX compiling and dispatching each
primitive for its op-by-op run.  The rays refract through the glass, so
``materials.refractive_index`` and ``materials.kt`` carry gradient through
the Snell rotation, the carried throughput and the shadow tint.
"""

import dataclasses
import os

import numpy as np
import pytest

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.scene import load_scene as jax_load_scene
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.scene import load_scene, make_scene
from test_torch_grad import check_grads
from test_torch_union_render import glass_soup_kwargs

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "scenes",
                       "example.json")


def with_lights(sc, n):
    """The scene with every emitter at ``n`` light samples."""
    return dataclasses.replace(sc, static=dataclasses.replace(
        sc.static, num_lights=tuple(n if k else 0
                                    for k in sc.static.num_lights)))


def example_scenes():
    return (with_lights(jax_load_scene(EXAMPLE), 8),
            with_lights(load_scene(EXAMPLE), 8))


def soup_scenes():
    kw = glass_soup_kwargs(nt=128)
    return (with_lights(jax_reorder(jax_make_scene(**kw)), 8),
            with_lights(reorder_scene(make_scene(**kw)), 8))


LIVE = ("materials.kt", "materials.refractive_index")
CASES = {
    "stack_dense_example": dict(
        scenes=example_scenes, res=(12, 12),
        kw=dict(max_bounces=2, light_chunk=8), live=LIVE),
    "stack_cluster_union": dict(
        scenes=soup_scenes, res=(8, 8),
        kw=dict(max_bounces=1, light_chunk=8, accel="cluster",
                bvh_cluster=16, bvh_shadow_cluster=32), live=LIVE),
}


@pytest.mark.parametrize("case", [c for c in CASES if "dense" in c])
def test_grads_match_jax(case, monkeypatch):
    check_grads(case, monkeypatch, CASES)

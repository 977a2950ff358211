"""The kt tint of transparent spheres on every shadow route of the cluster
sweep: a glass sphere over an opaque 128-triangle soup (the soup of
tests/test_torch_union_render.py made opaque, the sphere in its glass),
16x16, 2 bounces, 8 light samples, through the cluster route.

The JAX package drops the sphere/plane pre-pass tint in its union and
shared shadow modes when the shadow clusters hold no transparent triangle
(``accel/intersect.py:565-566``, ``:575-576`` there), so there the glass
sphere casts no shadow, while its per-ray mode tints.  The port keeps the
tint in every mode: union, shared and per-ray give the same frame bit for
bit, and it equals the JAX package's per-ray frame with the JAX draws
injected, at the tolerances of ``compare_frames``.
"""

import functools

import pytest
import torch

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import intersect, reorder_scene
from c_raytracer_tpu_torch.core import v3 as tv3
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import make_scene
from test_torch_union_render import compare_frames, glass_soup_kwargs

KW = dict(max_bounces=2, light_chunk=8, accel="cluster")


def sphere_over_soup_kwargs():
    kw = glass_soup_kwargs(nt=128)
    glass = kw["materials"][0]
    opaque = {k: v for k, v in glass.items()
              if k not in ("kt", "refractive_index")}
    kw["materials"] = [opaque] + kw["materials"][1:] + [glass]
    kw.update(sphere_center=[[0.0, 2.0, -1.0], [0.0, 6.0, -3.0]],
              sphere_radius=[1.0, 0.5], sphere_material=[4, 2],
              sphere_lights=[0, 8])
    return kw


@functools.lru_cache(maxsize=None)
def scenes():
    kw = sphere_over_soup_kwargs()
    return jax_reorder(jax_make_scene(**kw)), reorder_scene(make_scene(**kw))


def _frame(mode, **kw):
    _, sc = scenes()
    fn = make_renderer(sc.static, RenderConfig(shadow_mode=mode, **KW, **kw),
                       16, 16, device="cpu", with_stats=True)
    img, z, st = fn(sc.params, PhiloxSampler(2, "cpu"))
    return img, z, {k: float(v) for k, v in st.items()}


def test_every_mode_tints_the_same(monkeypatch):
    _, sc = scenes()
    assert sc.static.is_transparent == (False,) * 4 + (True,)
    ref = _frame("union")
    for mode in ("shared", "per_ray"):
        img, z, st = _frame(mode)
        assert torch.equal(img, ref[0]) and torch.equal(z, ref[1]), mode
        assert st == ref[2], mode
    # the sphere's tint reaches the union frame: without it the frame is
    # brighter
    monkeypatch.setattr(intersect.Intersector, "tint",
                        lambda self, counts: tv3.full(counts.shape[:-1], 1.0,
                                                      device="cpu"))
    untinted = _frame("union")[0]
    assert float((untinted - ref[0]).max()) > 1e-3 * float(ref[0].max())
    assert float((untinted - ref[0]).min()) >= 0


@pytest.mark.parametrize("mode", ["union", "per_ray"])
def test_matches_jax_per_ray(mode):
    """The port in ``mode`` against the JAX package's per-ray mode, the one
    JAX mode that keeps the sphere's tint."""
    jsc, sc = scenes()
    compare_frames(jsc, sc, dict(KW, shadow_mode="per_ray"), (16, 16), 11,
                   port_kw=dict(shadow_mode=mode))

"""The named residuals of the backward (``RenderConfig.remat_names``):
``shadow_samples`` (the light samples' directions and distances) and
``shade_terms`` (the diffuse cosine and the specular powf) beside
``occlusion``, as the JAX package names them with ``checkpoint_name``.

A name changes what the backward keeps, never the gradient.  Each named
tuple's grads are held against ``jax.grad`` of the JAX package's renderer
(op by op, its uniforms injected; tests/test_torch_grad.py's loss and
tolerance: every leaf within 1e-4 · max|g_jax|) and against the port's
grads under the default names, bit for bit (under
``torch.use_deterministic_algorithms``).  A dispatch-mode spy counts the
ops that run inside each ``remat.named`` block: under the default names
the backward's recompute runs them again, under a requested name it runs
none of them (their outputs come from the forward).  Without
``"occlusion"`` the backward sweeps occlusion again, as the JAX package's
does: the occlusion queries are counted as tests/test_torch_grad.py
counts them.

The scene is small and takes the chunk loop where the names act: two
spheres (one a sphere emitter of 12 samples, a tail chunk of 4 at
``light_chunk`` 8), a reflective ground triangle and a plane, so the
dense route shades through ``_shade_chunk`` (a triangle makes the fused
route ineligible); with ``accel="cluster"`` the same scene takes the
shared-origin sweep, whose directions are drawn in the round's region.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.core import remat
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import (make_scene, named_leaves,
                                         params_to_torch)
from test_torch_grad import (GRAD_RTOL, SCALE_OF, CountQueries, jax_grads,
                             port_grads)

RES = (8, 8)
BASE = dict(max_bounces=2, light_chunk=8)
NAMED = [("occlusion", "shadow_samples"), ("occlusion", "shade_terms"),
         ("occlusion", "shadow_samples", "shade_terms"),
         ("shadow_samples", "shade_terms")]


def scene_kwargs():
    mats = [dict(ks=[0.5] * 3, ka=[0.1] * 3, kr=[0.3] * 3, shininess=8.0,
                 tex_color=[0.9, 0.7, 0.5]),
            dict(ke=[6, 6, 6], tex_color=[1, 1, 1]),
            dict(ks=[0.3] * 3, ka=[0.2] * 3, tex_type=1,
                 tex_color=[.9, .9, .9], tex_color2=[.1, .1, .2],
                 tex_scale=1.3)]
    return dict(
        sphere_center=[[0, 0, 0], [0.5, 3, -1]], sphere_radius=[1.0, 0.5],
        sphere_material=[0, 1], sphere_lights=[0, 12],
        tri_vertices=[[[-3, -1, -3], [3, -1, -3], [0, -1, 3]]],
        tri_material=[0], plane_point=[[0, 0, 5]],
        plane_normal=[[0, 0, -1]], plane_material=[2], materials=mats,
        camera=dict(position=[0, 0.5, -5], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=55, focal_length=1),
        ambient=(0.2, 0.2, 0.2))


@functools.lru_cache(maxsize=None)
def scenes():
    kw = scene_kwargs()
    return jax_make_scene(**kw), make_scene(**kw)


def weights():
    rng = np.random.default_rng(5)
    resx, resy = RES
    return (rng.uniform(size=(resy, resx, 3)).astype(np.float32),
            rng.uniform(size=(resy, resx)).astype(np.float32) * 0.1)


@functools.lru_cache(maxsize=None)
def grads_of_jax():
    jsc, _ = scenes()
    w, wz = weights()
    return {n: np.asarray(g) for n, g in named_leaves(jax_grads(
        jsc.static, jsc.params, BASE, RES, jax.random.PRNGKey(3), w, wz))}


def grads_of_port(names, monkeypatch, **kw):
    """({leaf: grad}, (queries in the forward, in the backward))."""
    _, sc = scenes()
    w, wz = weights()
    g, q = port_grads(sc.static, sc.params,
                      dict(BASE, remat_names=names, **kw), RES,
                      jax.random.PRNGKey(3), w, wz,
                      CountQueries(monkeypatch))
    return {n: np.asarray(x) for n, x in named_leaves(g)}, q


@pytest.mark.parametrize("names", NAMED, ids="+".join)
def test_named_grads_match_jax_and_default(names, monkeypatch):
    g_jax = grads_of_jax()
    g_def, (_, bwd_def) = grads_of_port(("occlusion",), monkeypatch)
    g, (fwd_q, bwd_q) = grads_of_port(names, monkeypatch)
    assert fwd_q > 0 and bwd_def == 0
    if "occlusion" in names:
        assert bwd_q == 0, f"{bwd_q} occlusion queries in the backward"
    else:               # nothing kept: the recompute sweeps again
        assert bwd_q > 0
    live = 0
    for name, b in g_jax.items():
        a = g[name]
        np.testing.assert_array_equal(a, g_def[name], err_msg=name)
        scale = float(np.abs(g_jax[SCALE_OF.get(name, name)]).max(
            initial=0.0))
        if scale == 0.0:
            assert not np.any(a), name
            continue
        live += 1
        err = float(np.abs(a - b).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    assert live >= 8


class CountNamed(TorchDispatchMode):
    """Counts the ops dispatched inside each ``remat.named`` block (the
    detaches of the selective contexts' own bookkeeping aside)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = remat._ACTIVE.get()
        if name is not None and func is not torch.ops.aten.detach.default:
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def spied_step(names, **kw):
    """Named ops dispatched in the forward and in the backward of one
    step of mean(img²), and the grads."""
    _, sc = scenes()
    p = params_to_torch(sc.params, "cpu")
    for _, x in named_leaves(p):
        x.requires_grad_(True)
    fn = make_renderer(sc.static, RenderConfig(remat_names=names,
                                               **dict(BASE, **kw)),
                       *RES, device="cpu")
    spy = CountNamed()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with spy:
            img, _ = fn(p, PhiloxSampler(1, "cpu"))
            fwd, spy.counts = spy.counts, {}
            img.square().mean().backward()
    finally:
        torch.use_deterministic_algorithms(was)
    return fwd, spy.counts, {n: x.grad for n, x in named_leaves(p)}


@pytest.mark.parametrize("route", ["dense_per_chunk", "cluster_shared",
                                   "cluster_per_ray"])
def test_named_ops_are_not_recomputed(route):
    kw = {"dense_per_chunk": {},
          "cluster_shared": dict(accel="cluster"),
          "cluster_per_ray": dict(accel="cluster",
                                  shadow_mode="per_ray")}[route]
    both = (remat.SHADOW_SAMPLES, remat.SHADE_TERMS)
    fwd0, bwd0, g0 = spied_step(("occlusion",), **kw)
    assert set(fwd0) == set(both) and all(fwd0.values())
    # the default recomputes every named op, once per region around it
    assert all(bwd0[n] >= fwd0[n] for n in both)
    for names in NAMED[:3] + [("occlusion", "bogus")]:
        fwd, bwd, g = spied_step(names, **kw)
        assert fwd == fwd0, names
        for n in both:
            assert bwd.get(n, 0) == (0 if n in names else bwd0[n]), (names,
                                                                     n)
        for leaf, x in g0.items():
            assert (x is None) == (g[leaf] is None), leaf
            assert x is None or torch.equal(g[leaf], x), (names, leaf)

"""Gradients of the whole slice: the port's ``make_renderer`` under
``loss.backward()`` against ``jax.grad`` of the JAX package's renderer, for
the same loss and the same injected JAX uniforms (``JaxKeySampler`` of
tests/test_torch_render.py).

The loss is ``sum(img·w) + sum(z·wz)`` with fixed weights from a NumPy
seed.  The JAX side is evaluated op by op (``jax.disable_jit``,
``remat=False``), as the forward parity tests do, so that both sides take
the same discrete decisions (hits, occlusion, live lanes) and their
gradients differ only by float32 rounding and summation order: JAX sums a
pixel's samples in ``lax.scan`` order, the port chunk by chunk, and the
port's ``v3.sqrt`` (and its backward) runs in float64.

Tolerance, every leaf of ``SceneParams``: ``|g_port - g_jax| <= 1e-4 ·
max|g_jax|`` over the leaf, and a leaf whose JAX gradient is all zero must
be all zero in the port too.  One leaf is held at another's scale:
``camera.focal_length``, whose exact gradient is 0 (the image plane scales
with it, so the ray directions do not move, image.c:42-55), holds float32
cancellation noise on both sides, and is held at 1e-4 of the largest
``camera.position`` gradient.  (Measured: every other leaf within ~4e-6 of
its scale.)  Each case also checks that the port's grads
with ``remat`` on equal those with it off (exactly), and that the backward
makes no occlusion query: ``Intersector.shadow_query`` and ``any_counts``
are not called during ``backward()``.

Cases: the dense stand-in (kernel 2's route) with 12 light samples (lc 16,
a tail chunk) and 3 bounces, Phong/sqr; the stand-in tiled and padded,
Blinn/lin; the 128-triangle bumpy mesh of tests/test_grad_mesh_refract.py
through the cluster route with shared shortlist shadows and with per-ray
shadows; and that mesh lit by a triangle emitter.  The mesh cases run from
tests/test_torch_grad_mesh.py, so that each file takes under a minute
alone: nearly all of it is JAX compiling each primitive for its op-by-op
run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import make_renderer as jax_make_renderer
from c_raytracer_tpu.scene import types as JT
from c_raytracer_tpu_torch.accel import intersect
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import (grads_to_numpy, make_scene,
                                         named_leaves, params_to_torch)
from test_grad_mesh_refract import _bumpy_mesh_scene
from test_torch_render import JaxKeySampler, _stand_in

GRAD_RTOL = 1e-4    # of max |g_jax| over each leaf
# a leaf whose exact gradient is 0, held at the scale of another leaf
SCALE_OF = {"camera.focal_length": "camera.position"}


def bumpy_kwargs(n=8, triangle_emitter=False):
    """make_scene arguments for the geometry of ``_bumpy_mesh_scene``: 2·n²
    triangles of a height field under a sphere emitter, and one more
    triangle above the field, which shadows it or, with
    ``triangle_emitter``, is the emitter instead of the sphere.

    Two changes make the field's direct light and shadows live: each
    triangle's last two vertices are swapped, so its normal faces the
    emitter (in the JAX FD scene every hit is an inside hit, which takes no
    direct light), and the field's material reflects (kr 0.3), so chains
    live past the first round.  Both variants have the same shapes, so the
    op-by-op JAX run compiles each operation once for both."""
    xs = np.linspace(-3, 3, n + 1, dtype=np.float32)
    zs = np.linspace(-3, 3, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = 0.4 * np.sin(gx) * np.cos(gz)
    v = np.stack([gx, gy, gz], -1)
    tris = []
    for i in range(n):
        for j in range(n):
            a, b = v[i, j], v[i + 1, j]
            c, d = v[i + 1, j + 1], v[i, j + 1]
            tris += [[a, c, b], [a, d, c]]
    tris.append([[-1, 5, -1], [0, 5, 1], [1, 5, -1]])   # faces down
    tv = np.asarray(tris, np.float32)
    tri_material, tri_lights = [0] * len(tv), [0] * len(tv)
    sphere_lights = [4]
    if triangle_emitter:
        tri_material[-1], tri_lights[-1], sphere_lights = 1, 6, [0]
    return dict(
        sphere_center=[[0.0, 6.0, 0.0]], sphere_radius=[0.5],
        sphere_material=[1], sphere_lights=sphere_lights,
        tri_vertices=tv, tri_material=tri_material, tri_lights=tri_lights,
        materials=[
            dict(ks=[0.6, 0.6, 0.6], ka=[0.3, 0.3, 0.3], kr=[0.3, 0.3, 0.3],
                 shininess=4.0, tex_color=[0.9, 0.8, 0.7]),
            dict(ke=[30.0, 30.0, 30.0], tex_color=[1, 1, 1]),
        ],
        camera=dict(position=[0.0, 2.5, -5.0], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0.4], fov=70, focal_length=1),
        ambient=(0.25, 0.25, 0.25))


def bumpy_scenes(triangle_emitter=False):
    """(JAX scene, port scene) of the bumpy mesh, each from its own
    package's make_scene, checked equal."""
    kw = bumpy_kwargs(triangle_emitter=triangle_emitter)
    jsc, sc = JT.make_scene(**kw), make_scene(**kw)
    # the triangles of the JAX FD gates' scene, turned over
    ref = np.asarray(_bumpy_mesh_scene().params.tri_vertices)
    np.testing.assert_array_equal(
        np.asarray(jsc.params.tri_vertices)[:len(ref), [0, 2, 1]], ref)
    assert dataclasses.asdict(sc.static) == dataclasses.asdict(jsc.static)
    return jsc, sc


def jax_grads(static, params, kw, res, key, w, wz):
    resx, resy = res
    fn = jax_make_renderer(static, JaxConfig(remat=False, **kw), resx, resy,
                           jit=False)

    def loss(p):
        img, z = fn(p, key)
        return jnp.sum(img * w) + jnp.sum(z * wz)

    with jax.disable_jit():
        return jax.grad(loss)(params)


class CountQueries:
    """Counts calls of the intersector's occlusion queries."""

    def __init__(self, monkeypatch):
        self.calls = 0
        for name in ("shadow_query", "any_counts"):
            real = getattr(intersect.Intersector, name)

            def counted(*a, _real=real, **k):
                self.calls += 1
                return _real(*a, **k)
            monkeypatch.setattr(intersect.Intersector, name, counted)


def port_grads(static, params, kw, res, key, w, wz, queries):
    """The port's grads of the same loss, and (queries in the forward,
    queries in the backward)."""
    resx, resy = res
    tile = kw.get("tile_size") or resx * resy
    p = params_to_torch(params, "cpu")
    for _, x in named_leaves(p):
        x.requires_grad_(True)
    fn = make_renderer(static, RenderConfig(**kw), resx, resy, device="cpu")
    # the backward of the cluster sweeps' row gathers is index_put_ with
    # accumulate=True, which on the CPU sums in a thread-dependent order
    # (from ~32k elements) unless deterministic algorithms are on; the
    # remat check compares bits
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        queries.calls = 0
        img, z = fn(p, JaxKeySampler(key, -(-(resx * resy) // tile)))
        fwd_calls, queries.calls = queries.calls, 0
        loss = ((img * torch.from_numpy(w)).sum()
                + (z * torch.from_numpy(wz)).sum())
        loss.backward()
    finally:
        torch.use_deterministic_algorithms(was)
    return grads_to_numpy(p), (fwd_calls, queries.calls)


CASES = {
    "dense_phong_sqr_tail_chunk": dict(
        scene="stand_in", lights=12, res=(16, 16),
        kw=dict(max_bounces=3)),
    # 320 px in two tiles of 256, the second padded
    "dense_tiled_blinn_lin": dict(
        scene="stand_in", lights=12, res=(20, 16),
        kw=dict(tile_size=256, reflection_model="blinn",
                light_attenuation="lin", max_bounces=2)),
    "mesh_cluster_shared": dict(
        scene="bumpy", res=(12, 12),
        kw=dict(max_bounces=2, accel="cluster", light_chunk=8)),
    "mesh_cluster_per_ray": dict(
        scene="bumpy", res=(12, 12),
        kw=dict(max_bounces=2, accel="cluster", light_chunk=8,
                shadow_mode="per_ray")),
    "mesh_triangle_emitter": dict(
        scene="bumpy_tri_emitter", res=(12, 12),
        kw=dict(max_bounces=2, accel="cluster", light_chunk=8)),
}


def check_grads(case, monkeypatch, cases=CASES):
    """Case ``case`` of ``cases``: the port's grads against JAX's, remat on
    against off, and no occlusion query in the backward.  A case names its
    scene, or gives ``scenes``, a function returning (JAX scene, port
    scene)."""
    c = cases[case]
    if "scenes" in c:
        jsc, sc = c["scenes"]()
        jstatic, jparams, static, params = (jsc.static, jsc.params,
                                            sc.static, sc.params)
    elif c["scene"] == "stand_in":
        static, params = _stand_in(lights=c["lights"])
        jstatic, jparams = static, params
    else:
        jsc, sc = bumpy_scenes(c["scene"] == "bumpy_tri_emitter")
        jstatic, jparams, static, params = (jsc.static, jsc.params,
                                            sc.static, sc.params)
    resx, resy = c["res"]
    rng = np.random.default_rng(5)
    w = rng.uniform(size=(resy, resx, 3)).astype(np.float32)
    wz = rng.uniform(size=(resy, resx)).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(3)
    queries = CountQueries(monkeypatch)

    g_jax = jax_grads(jstatic, jparams, c["kw"], c["res"], key, w, wz)
    g, (fwd_q, bwd_q) = port_grads(static, params, c["kw"], c["res"], key,
                                   w, wz, queries)
    g_off, _ = port_grads(static, params, dict(c["kw"], remat=False),
                          c["res"], key, w, wz, queries)

    assert bwd_q == 0, f"{bwd_q} occlusion queries in the backward"
    if c.get("scene") != "stand_in":
        assert fwd_q > 0          # the non-fused route queried occlusion
    jax_max = {name: float(np.abs(np.asarray(b)).max(initial=0.0))
               for name, b in named_leaves(g_jax)}
    for name in c.get("live", ()):       # leaves the case is about
        assert jax_max[name] > 0, f"{name}: no gradient in this case"
    nonzero = 0
    for (name, a), (_, b), (_, a_off) in zip(
            named_leaves(g), named_leaves(g_jax), named_leaves(g_off)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, a_off, err_msg=f"{name}: remat")
        assert np.all(np.isfinite(a)), name
        scale = jax_max[SCALE_OF.get(name, name)]
        if scale == 0.0:
            assert not np.any(a), f"{name}: JAX grad is zero, port's is not"
            continue
        nonzero += 1
        err = float(np.abs(a - b).max())
        assert err <= GRAD_RTOL * scale, (
            f"{name}: max |port - jax| {err:.3e} > {GRAD_RTOL} x {scale:.3e}")
    assert nonzero >= 8   # geometry, materials, camera and ambient all live


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("dense")])
def test_grads_match_jax(case, monkeypatch):
    check_grads(case, monkeypatch)

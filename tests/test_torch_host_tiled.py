"""The host-tiled entry points: ``make_host_tiled_renderer`` renders the
tiles of ``make_renderer`` in batches of ``tiles_per_call`` from a host
loop, and ``make_host_tiled_value_and_grad`` takes a gradient step batch
by batch, each batch with its own graph.

* The host-tiled frame and stats equal ``make_renderer``'s bit for bit,
  with 1 and 3 tiles a batch and a padded last tile, on the dense stand-in
  (chain, kernel 2's route) and on the transparent lit soup of
  tests/test_parallel.py (cluster stack, union shadows), both under path
  GI.
* The host-tiled loss and grads, with and without a target, equal those
  of ``make_renderer``'s backward of the same loss under path GI (loss
  rtol 1e-5; each leaf within rtol 1e-5 and 1e-5 of its largest entry: the
  batches' grads sum in another order), and those of the JAX package's
  ``make_host_tiled_value_and_grad`` run op by op with its draws injected
  (the tolerances of tests/test_torch_grad.py: 1e-4 of each leaf's largest
  JAX entry), on the dense stand-in with 4 light samples, 1 bounce and
  ambient GI: op by op, JAX's path-GI step takes a minute, and path GI's
  gradients are held against JAX in tests/test_torch_grad_gi.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import \
    make_host_tiled_value_and_grad as jax_host_tiled_vg
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import (RenderConfig,
                                          make_host_tiled_renderer,
                                          make_host_tiled_value_and_grad,
                                          make_renderer, render)
from c_raytracer_tpu_torch.scene import (load_scene, named_leaves,
                                         params_to_torch)
from test_parallel import _lit_soup
from test_torch_grad import GRAD_RTOL, SCALE_OF
from test_torch_render import JaxKeySampler, _stand_in

pytest_plugins = ("torch_harness",)

GI = dict(gi_model="path", samples_per_pixel=2)
# 16x12 = 192 pixels in tiles of 80: 3 tiles, the last padded by 48
RES, TILE = (16, 12), 80


def _scene(name, lights=12):
    if name == "stand_in":
        return _stand_in(lights=lights) + (dict(GI, max_bounces=2),)
    sc = jax_reorder(_lit_soup())
    return sc.static, sc.params, dict(GI, max_bounces=2, light_chunk=4)


@pytest.mark.parametrize("tiles_per_call", [1, 3])
@pytest.mark.parametrize("name", ["stand_in", "lit_soup"])
def test_host_tiled_frame_is_make_renderers(name, tiles_per_call):
    static, params, kw = _scene(name)
    cfg = RenderConfig(tile_size=TILE, **kw)
    a = make_renderer(static, cfg, *RES, device="cpu", with_stats=True)(
        params, PhiloxSampler(3, "cpu"))
    b = make_host_tiled_renderer(static, cfg, *RES, device="cpu",
                                 tiles_per_call=tiles_per_call,
                                 with_stats=True)(
        params, PhiloxSampler(3, "cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert {k: float(v) for k, v in a[2].items()} == {
        k: float(v) for k, v in b[2].items()}
    assert float(a[2]["gi_rays"]) > 0 and a[0].max() > 0


def test_render_convenience():
    """``render`` is ``make_renderer``'s frame under Philox seed 0."""
    sc = load_scene(os.path.join(os.path.dirname(__file__), "..", "scenes",
                                 "spheres_opaque.json"))
    cfg = RenderConfig(max_bounces=1)
    img, z = render(sc, cfg, 8, 8, device="cpu")
    ref = make_renderer(sc.static, cfg, 8, 8, device="cpu")(
        sc.params, PhiloxSampler(0, "cpu"))
    assert torch.equal(img, ref[0]) and torch.equal(z, ref[1])


def pixel_loss(color, z, target):
    if target is None:
        return (color * color).sum(-1) + 0.1 * z
    return ((color - target) ** 2).sum(-1)


def jax_pixel_loss(color, z, target):
    if target is None:
        return jnp.sum(color * color, -1) + 0.1 * z
    return jnp.sum((color - target) ** 2, -1)


def _target(with_target):
    if not with_target:
        return None
    return np.random.default_rng(8).uniform(
        size=(RES[0] * RES[1], 3)).astype(np.float32)


def _host_tiled(static, params, cfg, sampler, target):
    vg = make_host_tiled_value_and_grad(static, cfg, *RES, pixel_loss,
                                        device="cpu", tiles_per_call=2)
    return vg(params, sampler,
              None if target is None else torch.from_numpy(target))


@pytest.mark.parametrize("with_target", [False, True])
def test_host_tiled_grads_match_make_renderer(with_target):
    static, params, kw = _scene("stand_in")
    cfg = RenderConfig(tile_size=TILE, **kw)
    target = _target(with_target)
    loss, grads = _host_tiled(static, params, cfg, PhiloxSampler(6, "cpu"),
                              target)

    p = params_to_torch(params, "cpu")
    for _, x in named_leaves(p):
        x.requires_grad_(True)
    img, z = make_renderer(static, cfg, *RES, device="cpu")(
        p, PhiloxSampler(6, "cpu"))
    whole = pixel_loss(img.reshape(-1, 3), z.reshape(-1),
                       None if target is None else torch.from_numpy(target))
    whole = whole.sum()
    whole.backward()
    assert loss == pytest.approx(float(whole.detach()), rel=1e-5)
    live = 0
    for (name, g), (_, x) in zip(named_leaves(grads), named_leaves(p)):
        g = g.numpy()
        ref = np.zeros_like(g) if x.grad is None else x.grad.numpy()
        scale = np.abs(ref).max(initial=0.0)
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)
        live += scale > 0
    assert live >= 8


@pytest.mark.parametrize("with_target", [False, True])
def test_host_tiled_grads_match_jax(with_target):
    static, params, kw = _scene("stand_in", lights=4)
    kw = dict(kw, gi_model="ambient", max_bounces=1)
    target = _target(with_target)
    key = jax.random.PRNGKey(6)
    loss, grads = _host_tiled(static, params, RenderConfig(tile_size=TILE,
                                                           **kw),
                              JaxKeySampler(key, -(-RES[0] * RES[1] // TILE)),
                              target)
    with jax.disable_jit():
        j_loss, j_grads = jax_host_tiled_vg(
            static, JaxConfig(remat=False, tile_size=TILE, **kw), *RES,
            jax_pixel_loss, tiles_per_call=2)(
            params, key, None if target is None else jnp.asarray(target))
    assert loss == pytest.approx(float(j_loss), rel=1e-5)
    j_named = dict(named_leaves(j_grads))
    j_max = {n: float(np.abs(np.asarray(g)).max(initial=0.0))
             for n, g in j_named.items()}
    live = 0
    for name, g in named_leaves(grads):
        g = g.numpy()
        assert np.all(np.isfinite(g)), name
        scale = j_max[SCALE_OF.get(name, name)]
        err = float(np.abs(g - np.asarray(j_named[name])).max(initial=0.0))
        assert err <= GRAD_RTOL * scale or (scale == 0 and err == 0), name
        live += scale > 0
    assert live >= 8

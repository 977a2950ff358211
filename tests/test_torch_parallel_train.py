"""The port's ``sp`` replicas and training step in one process, against
the JAX package's sample-parallel frame and ``loss_and_grad_fn``.

Each ``sp`` replica renders ``samples_per_pixel // n_sp`` GI samples from
its own sampler; their mean is held against JAX's frame on a mesh of two
CPU devices on ``sp`` with JAX's ``split(key, 2)`` keys injected, within
1e-5·max (the port's tolerance against JAX, tests/test_torch_render.py),
z at rtol 1e-6.  The train step's loss within rtol 1e-5 and every leaf's
gradient within 1e-4·max|g| of ``jax.grad``'s (tests/test_torch_grad.py's
tolerance and its scale for ``camera.focal_length``, whose exact gradient
is 0), through the ``pr`` fold of 2 stacked triangle ranges.  The JAX side
runs op by op (``jax.disable_jit``, ``remat=False``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from c_raytracer_tpu.parallel import make_mesh as jax_make_mesh
from c_raytracer_tpu.parallel import make_sharded_renderer as jax_sharded
from c_raytracer_tpu.parallel.train import loss_and_grad_fn as jax_lag
from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu_torch.parallel import make_mesh, make_train_step
from c_raytracer_tpu_torch.parallel.mesh import Mesh
from c_raytracer_tpu_torch.parallel.render_sharded import ShardedFrame
from c_raytracer_tpu_torch.render import RenderConfig
from c_raytracer_tpu_torch.scene import params_to_torch
from c_raytracer_tpu_torch.scene.convert import named_leaves
from test_torch_parallel import RES, lit, npy
from test_torch_render import JaxKeySampler

GRAD_RTOL = 1e-4
SCALE_OF = {"camera.focal_length": "camera.position"}


def test_sp_replicas_match_jax():
    """Two ``sp`` replicas of path GI spp 4: each renders spp 2 from its
    own sampler (JAX's ``split(key, 2)[s]``), and their mean is JAX's
    sample-parallel frame (a mesh of 2 CPU devices on ``sp``)."""
    jsc, _ = lit(False, nt=32)
    static, params = jsc.static, jsc.params
    kw = dict(max_bounces=1, gi_model="path", samples_per_pixel=4,
              light_chunk=4)
    key = jax.random.PRNGKey(0)
    with jax.disable_jit():
        mesh = jax_make_mesh(n_px=1, n_sp=2, devices=jax.devices()[:2])
        j_img, j_z = jax_sharded(static, JaxConfig(remat=False, **kw), 8, 8,
                                 mesh, jit=False)(params, key)
    samplers = [JaxKeySampler(k, 1) for k in jax.random.split(key, 2)]
    cfg = RenderConfig(**kw)
    colors, zs = [], []
    for s in range(2):
        sf = ShardedFrame(static, cfg, 8, 8, Mesh((1, 2, 1), (0, s, 0)),
                          "cpu")
        assert sf.cfg.samples_per_pixel == 2
        c, z, _ = sf.local(params_to_torch(params, "cpu"), samplers, False)
        colors.append(c)
        zs.append(z)
    img = ((colors[0] + colors[1]) / 2).reshape(8, 8, 3)
    assert float(np.asarray(j_img).max()) > 0
    np.testing.assert_allclose(npy(img), np.asarray(j_img), rtol=0,
                               atol=1e-5 * float(np.asarray(j_img).max()))
    np.testing.assert_allclose(npy(zs[0]).reshape(8, 8), np.asarray(j_z),
                               rtol=1e-6, atol=0)
    # fewer samples than replicas: every replica takes them all
    sf = ShardedFrame(static, RenderConfig(**{**kw, "samples_per_pixel": 1}),
                      8, 8, Mesh((1, 2, 1), (0, 1, 0)), "cpu")
    assert sf.cfg.samples_per_pixel == 1


def test_train_step_grads_through_the_pr_fold_match_jax():
    """``make_train_step`` with the triangles in 2 stacked ranges: the loss
    and every leaf's gradient (tri_vertices through the fold's winner
    select) against JAX's ``loss_and_grad_fn`` on a 1x1x2 mesh."""
    jsc, tsc = lit(False, nt=96)
    kw = dict(max_bounces=1, light_chunk=4, accel="none", tri_chunk=64)
    key = jax.random.PRNGKey(0)
    target = np.full((RES, RES, 3), 0.01, np.float32)
    with jax.disable_jit():
        mesh = jax_make_mesh(n_px=1, n_sp=1, n_pr=2,
                             devices=jax.devices()[:2])
        j_loss, j_grads = jax_lag(jsc.static, JaxConfig(remat=False, **kw),
                                  RES, RES, mesh)(jsc.params, key,
                                                  jnp.asarray(target))
    step = make_train_step(tsc.static, RenderConfig(**kw), RES, RES,
                           make_mesh(), device="cpu", with_grads=True,
                           shards=2, learning_rate=0.5)
    new, loss, grads = step(tsc.params, JaxKeySampler(key, 1),
                            torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    jg = dict(named_leaves(j_grads))
    tg = dict(named_leaves(grads))
    scale = {k: float(np.abs(np.asarray(g)).max()) if np.size(g) else 0.0
             for k, g in jg.items()}
    assert scale["tri_vertices"] > 0
    for k, g in tg.items():
        s = scale[SCALE_OF.get(k, k)]
        err = float(np.abs(npy(g) - np.asarray(jg[k])).max()) \
            if g.numel() else 0.0
        assert err <= GRAD_RTOL * s, f"{k}: {err:.3e} > {GRAD_RTOL} x {s:.3e}"
    # plain SGD on every leaf
    p = dict(named_leaves(tsc.params))
    for k, x in named_leaves(new):
        np.testing.assert_allclose(npy(x), np.asarray(p[k], np.float32)
                                   - 0.5 * npy(tg[k]), rtol=1e-6, atol=1e-7)

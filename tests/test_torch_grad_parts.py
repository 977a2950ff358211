"""The gradient pieces of the port, one module at a time, against the JAX
package's on the same NumPy inputs: the closed-form VJP of ``fmax0_powf``,
the backward of kernel 2's route (its plain version's autograd, which
``_FusedChunk.backward`` runs on the card), the rematerialisation helpers
of ``core/remat.py`` and the leaves that ``params_to_torch`` hands back.
The JAX side runs op by op (``jax.disable_jit``), as the forward parity
tests do."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.core import cmath as jcm
from c_raytracer_tpu.render import shading as jsh
from c_raytracer_tpu_torch.core import cmath as tcm
from c_raytracer_tpu_torch.core import remat
from c_raytracer_tpu_torch.render import RenderConfig, fused_shadow
from c_raytracer_tpu_torch.scene import (grads_to_numpy, load_scene,
                                         named_leaves, params_to_torch)
from test_torch_render import SCENE
from test_torch_shading import _chunk_inputs, _grid


@pytest.mark.parametrize("shape", ["same", "scalar_exponent"])
def test_fmax0_powf_vjp_matches_jax(shape):
    """dx and ds of sum(fmax0_powf(x, s) · g) on the C-semantics grid of
    tests/test_torch_shading.py (negative integral and fractional powers,
    ±0, 1e-30, NaN): zeros, infinities (overflowing lanes such as 40^120)
    and NaNs where JAX's are, the rest within 1e-6 relative.  The cotangent
    is NaN on the lanes whose primal is clamped to 0, and must not leak
    from there; the one NaN left is C's powf(NaN, 0) = 1, an active lane
    whose base is NaN.  ``scalar_exponent`` broadcasts one exponent over
    every base, so ds is the sum over the lanes."""
    b, e = _grid()
    if shape == "scalar_exponent":
        e = np.asarray([7.5], np.float32)
    p = np.asarray(jcm.fmax0_powf(jnp.asarray(b), jnp.asarray(e)))
    g = np.random.default_rng(0).uniform(0.5, 2.0, p.shape).astype(np.float32)
    g[p <= 0] = np.nan     # dead lanes: a NaN cotangent stays inside
    with jax.disable_jit():
        _, vjp = jax.vjp(jcm.fmax0_powf, jnp.asarray(b), jnp.asarray(e))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    bt = torch.from_numpy(b).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True)
    tcm.fmax0_powf(bt, et).backward(torch.from_numpy(g))
    for name, got, w in (("dx", bt.grad.numpy(), want[0]),
                         ("ds", et.grad.numpy(), want[1])):
        assert got.shape == w.shape, name
        np.testing.assert_array_equal(np.isnan(got), np.isnan(w),
                                      err_msg=name)
        np.testing.assert_array_equal(got == 0, w == 0, err_msg=name)
        np.testing.assert_allclose(got, w, rtol=1e-6, err_msg=name)
    dx = bt.grad.numpy()
    assert not np.any(dx[p <= 0]) and np.count_nonzero(dx) > 10
    assert np.all(np.isnan(b[np.isnan(dx)]))


@pytest.mark.parametrize("phong,atten", [(True, "sqr"), (False, "lin")],
                         ids=["phong_sqr", "blinn_lin"])
def test_fused_chunk_grads_match_jax(phong, atten):
    """The grads of px and scal_f through kernel 2's plain version (the
    route of ``_FusedChunk.backward``) against ``jax.grad`` of the JAX
    package's plain chunk, a tail chunk of 12 valid samples in 16.  The
    JAX package differentiates its kernel the same way, by autograd of
    this plain version at the same u (``fused_shadow.py:221-237``).
    Tolerance: 1e-4 · max |g_jax| over each operand."""
    ns, npl, egid, P, lc, n_valid = 4, 2, 2, 256, 16, 12
    u, px, scal_f = _chunk_inputs(7, lc, P, ns, npl, egid)
    w = np.random.default_rng(1).uniform(size=(3, P)).astype(np.float32)
    ref = jsh._packed_sphere_chunk_ref(phong, lc, ns, npl, egid, atten)

    def loss(px_, scal_):
        out = ref(jnp.asarray(u), px_, scal_, jnp.asarray([n_valid]))
        return jnp.sum(out * w)

    with jax.disable_jit():
        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(px),
                                                jnp.asarray(scal_f))
    px_t = torch.from_numpy(px).requires_grad_(True)
    sc_t = torch.from_numpy(scal_f).requires_grad_(True)
    out = fused_shadow.fused_chunk(torch.from_numpy(u), px_t, sc_t, n_valid,
                                   lc=lc, ns=ns, npl=npl, egid=egid,
                                   phong=phong, atten_kind=atten)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, b in (("px", px_t.grad, want[0]),
                         ("scal_f", sc_t.grad, want[1])):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), b, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_checkpoint_regions_match_plain_autograd():
    """``remat.checkpoint``: the same value and grads as the plain call,
    with the region's inner tensors recomputed (its forward runs twice
    under autograd) and run once without grad or without ``cfg.remat``."""
    calls = []

    def region(x, k):
        calls.append(1)
        return (x.sin() * k).exp().sum()

    x0 = torch.linspace(-1, 1, 50)
    grads = {}
    for on in (True, False):
        calls.clear()
        x = x0.clone().requires_grad_(True)
        y = remat.checkpoint(RenderConfig(remat=on), region, x, 0.5)
        y.backward()
        grads[on] = (y.item(), x.grad.clone(), len(calls))
    assert grads[True][0] == grads[False][0]
    torch.testing.assert_close(grads[True][1], grads[False][1], rtol=0,
                               atol=0)
    assert (grads[True][2], grads[False][2]) == (2, 1)
    with torch.no_grad():
        calls.clear()
        remat.checkpoint(RenderConfig(), region, x0, 0.5)
        assert len(calls) == 1


def test_nested_region_arguments_are_not_kept():
    """A tensor that reaches an inner region inside a V3 is recomputed by
    the enclosing region, not kept alive until the backward (as a V3
    passed whole to ``torch.utils.checkpoint`` would be), and the grads
    still equal plain autograd's."""
    from c_raytracer_tpu_torch.core.v3 import V3

    alive = []

    def inner(v, k):
        return ((v.x * v.y + v.z) * k).sum()

    def outer(x):
        b = x.exp() * 2.0
        alive.append(weakref.ref(b))
        return remat.checkpoint(cfg, inner, V3(b, b.sin(), b.cos()), 0.5)

    x0 = torch.linspace(-1, 1, 10000)
    grads = []
    for on in (True, False):
        cfg = RenderConfig(remat=on)
        x = x0.clone().requires_grad_(True)
        y = remat.checkpoint(cfg, outer, x)
        if on:
            gc.collect()
            assert alive[-1]() is None
        y.backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_saved_occlusion_sweeps_once_per_path():
    """``remat.saved_occlusion`` runs the sweep without autograd on the
    first call of a sample path and serves its result on the recompute's;
    with no store (remat off) it sweeps every time."""
    sweeps = []
    leaf = torch.ones(4, requires_grad=True)

    def sweep():
        sweeps.append(torch.is_grad_enabled())
        return leaf * 2 > 1

    store = {}
    first = remat.saved_occlusion(store, (0, 1, 2), sweep)
    again = remat.saved_occlusion(store, (0, 1, 2), sweep)
    other = remat.saved_occlusion(store, (0, 1, 3), sweep)
    assert first is again and other is not first and sweeps == [False, False]
    remat.saved_occlusion(None, (0, 1, 2), sweep)
    remat.saved_occlusion(None, (0, 1, 2), sweep)
    assert len(sweeps) == 4 and not any(sweeps)


def test_params_to_torch_keeps_leaves_and_reads_grads():
    """A leaf that already is a float32 tensor on the device comes back as
    itself, so ``backward()`` fills the caller's ``.grad``;
    ``grads_to_numpy`` reads them back, zeros where a leaf has none."""
    p = params_to_torch(load_scene(SCENE).params, "cpu")
    again = params_to_torch(p, "cpu")
    for (name, a), (_, b) in zip(named_leaves(p), named_leaves(again)):
        assert a is b, name
    p.sphere_radius.requires_grad_(True)
    (p.sphere_radius ** 2).sum().backward()
    g = grads_to_numpy(again)
    np.testing.assert_array_equal(
        g.sphere_radius, 2 * p.sphere_radius.detach().numpy())
    for name, leaf in named_leaves(g):
        assert leaf.shape == tuple(dict(named_leaves(p))[name].shape), name
        if name != "sphere_radius":
            assert not np.any(leaf), name

"""The pieces of the stack integrator and of transparent shadows, the port
against the JAX package on the same NumPy inputs: ``refract_dir``, the
inside-object re-test ``intersect_prim_soa``, the ray stack's init, pop and
push, the union visit order and the union ``shadow_query``, and the kt
tint formed from blocker counts.

The JAX side runs op by op (``jax.disable_jit``): compiled, XLA contracts
the products of ``jnp.cross`` into FMAs.  Tolerances: masks, ids, counts,
spill and stack contents exact; directions 2e-6 absolute (arccos, arcsin,
sin and cos round differently in XLA and in torch: up to 2 ulp apart on
the CPU); hit distances and normals rtol 1e-6; tints rtol 1e-6 (the port's
``pow`` of a count against the JAX package's running product).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.accel import make_intersector as jax_make_intersector
from c_raytracer_tpu.accel import traverse as JT
from c_raytracer_tpu.core import v3 as jv3
from c_raytracer_tpu.geometry import primitives as JG
from c_raytracer_tpu.render import integrator as JI
from c_raytracer_tpu.render import shading as JS
from c_raytracer_tpu.render.config import RenderConfig as JaxConfig
from c_raytracer_tpu_torch.accel import intersect
from c_raytracer_tpu_torch.accel import make_intersector
from c_raytracer_tpu_torch.accel import traverse as TT
from c_raytracer_tpu_torch.core import v3 as tv3
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.geometry import primitives as TG
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.render import integrator as TI
from c_raytracer_tpu_torch.render import shading as TS
from c_raytracer_tpu_torch.scene import params_to_torch
from test_torch_accel import _shadow_inputs, packs, rays, soup, t
from test_torch_union_render import glass_soup


@pytest.fixture(autouse=True)
def _jax_op_by_op():
    with jax.disable_jit():
        yield


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def refract_inputs():
    """64 lanes: random incidence from both sides at ior 1.5, with total
    internal reflection (grazing from inside), exact normal incidence, |b|
    pushed past 1, and a zero ray (a dead stack lane)."""
    rng = np.random.default_rng(21)
    P = 64
    d, n = _unit(rng, P), _unit(rng, P)
    d[0] = -n[0]                                     # normal incidence
    d[1] = n[1]                                      # normal, from inside
    d[2] = (0.2 * n[2] + _unit(rng, 1)[0]).astype(np.float32)   # grazing
    d[2] /= np.linalg.norm(d[2])
    d[5] = n[5] = 0.0                                # zero ray
    b = np.sum(d * n, 1).astype(np.float32)
    b[0], b[1] = -1.0, 1.0                           # |b| = 1 exactly
    b[3], b[4] = np.float32(1.0000001), np.float32(-1.25)     # |b| > 1
    is_out = np.signbit(b)
    ior = np.full(P, 1.5, np.float32)
    return d, n, b, is_out, ior


def test_refract_dir_matches_jax_with_finite_grads():
    d, n, b, is_out, ior = refract_inputs()
    w = np.random.default_rng(22).uniform(-1, 1, (3, 64)).astype(np.float32)

    def jloss(d, n, b, ior):
        out, _ = JS.refract_dir(jv3.from_aos(d), jv3.from_aos(n), b,
                                jnp.asarray(is_out), ior)
        return sum(jnp.sum(c * wc) for c, wc in zip(out, w))

    jout, jvalid = JS.refract_dir(jv3.from_aos(jnp.asarray(d)),
                                  jv3.from_aos(jnp.asarray(n)),
                                  jnp.asarray(b), jnp.asarray(is_out),
                                  jnp.asarray(ior))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(d), jnp.asarray(n), jnp.asarray(b), jnp.asarray(ior))

    args = [t(x).requires_grad_(True) for x in (d, n, b, ior)]
    out, valid = TS.refract_dir(tv3.from_aos(args[0]),
                                tv3.from_aos(args[1]), args[2],
                                t(is_out), args[3])
    sum((c * t(wc)).sum() for c, wc in zip(out, w)).backward()

    valid = valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    # the lanes the reference turns into NaN are the ones marked invalid
    assert not valid[[0, 1, 5]].any() and not valid.all()
    tir = ~valid & (np.abs(b) < 1) & (np.abs(b) > 0)
    assert tir.any()                                   # a TIR lane
    np.testing.assert_allclose(tv3.to_aos(out).detach().numpy(),
                               np.asarray(jv3.to_aos(jout)), rtol=0,
                               atol=2e-6)
    for a, g in zip(args, jg):
        ga, g = a.grad.numpy(), np.asarray(g)
        assert np.all(np.isfinite(ga)), "a masked lane's gradient"
        np.testing.assert_allclose(ga, g, rtol=0,
                                   atol=1e-4 * np.abs(g).max())


def _soup_scenes():
    """The transparent soup (both packages' scenes) and its device
    scenes."""
    jsc, tsc = soup(True)
    jds = JG.device_scene(jsc.params, jsc.static)
    tds = TG.device_scene(params_to_torch(tsc.params, "cpu"), tsc.static)
    return jsc, tsc, jds, tds


def test_intersect_prim_soa_matches_jax():
    """The inside re-test of one primitive per ray: the sphere, triangles
    and the plane of the soup, and gid = -1 (a miss)."""
    jsc, tsc, jds, tds = _soup_scenes()
    rng = np.random.default_rng(24)
    n_prims = tsc.static.n_prims
    gid = rng.integers(-1, n_prims, 300)
    gid[:4] = [-1, 0, 1, n_prims - 1]                 # miss, sphere, tri, plane
    # rays from random origins aimed near their primitive (a sphere's
    # centre, a triangle's centroid, a point of the plane); a sixth start
    # inside the sphere, as a refracted ray does
    o, _ = rays(23, 300)
    tv = np.asarray(tsc.params.tri_vertices)
    target = np.zeros((300, 3), np.float32)
    for i, g in enumerate(gid):
        if g == 0:
            target[i] = tsc.params.sphere_center[0]
        elif 1 <= g < n_prims - 1:
            target[i] = tv[g - 1].mean(0)
        else:
            target[i] = [rng.uniform(-3, 3), -4, rng.uniform(-3, 3)]
    o[(gid == 0) & (np.arange(300) % 2 == 0)] = 0.1
    d = target + rng.normal(0, 0.05, (300, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jt_, jh, jn = JG.intersect_prim_soa(jds, jv3.from_aos(jnp.asarray(o)),
                                        jv3.from_aos(jnp.asarray(d)),
                                        jnp.asarray(gid, jnp.int32))
    tt_, th, tn = TG.intersect_prim_soa(tds, tv3.from_aos(t(o)),
                                        tv3.from_aos(t(d)),
                                        torch.from_numpy(gid))
    th = th.numpy()
    np.testing.assert_array_equal(th, np.asarray(jh))
    assert th.any() and not th[0]
    np.testing.assert_allclose(tt_.numpy()[th], np.asarray(jt_)[th],
                               rtol=1e-6)
    np.testing.assert_allclose(tv3.to_aos(tn).numpy()[th],
                               np.asarray(jv3.to_aos(jn))[th], rtol=1e-6,
                               atol=1e-7)
    kinds = np.where(gid < 1, gid, np.where(gid < n_prims - 1, 1, 2))
    assert {0, 1, 2} <= set(kinds[th].tolist())       # every kind hit


def test_stack_pop_push_match_jax():
    """Init, pop and two pushes per round on a stack of 3 slots over 5
    rounds, overflow included: every field and the count equal."""
    rng = np.random.default_rng(25)
    P, S = 40, 3
    o, d = (rng.normal(size=(P, 3)).astype(np.float32) for _ in range(2))
    jst = JI._stack_init(jv3.from_aos(jnp.asarray(o)),
                         jv3.from_aos(jnp.asarray(d)), 4, S)
    tst = TI._stack_init(tv3.from_aos(t(o)), tv3.from_aos(t(d)), 4, S)
    drops = 0
    for r in range(5):
        (jo, jd, jkr, jrem, jin), jact, jst = JI._stack_pop(jst)
        (to_, td, tkr, trem, tin), tact, tst = TI._stack_pop(tst)
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
        for a, b in ((to_, jo), (td, jd), (tkr, jkr)):
            np.testing.assert_array_equal(tv3.to_aos(a).numpy(),
                                          np.asarray(jv3.to_aos(b)))
        np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
        for k in range(2):
            push = rng.uniform(size=P) < 0.7
            v = [rng.normal(size=(P, 3)).astype(np.float32)
                 for _ in range(3)]
            rem = rng.integers(0, 4, P)
            ins = rng.integers(-1, 9, P)
            before = tst.count.clone()
            jst = JI._stack_push(jst, jnp.asarray(push),
                                 *(jv3.from_aos(jnp.asarray(x)) for x in v),
                                 jnp.asarray(rem, jnp.int32),
                                 jnp.asarray(ins, jnp.int32))
            tst = TI._stack_push(tst, torch.from_numpy(push),
                                 *(tv3.from_aos(t(x)) for x in v),
                                 torch.from_numpy(rem), torch.from_numpy(ins))
            drops += int(push.sum() - (tst.count - before).sum())
        np.testing.assert_array_equal(tst.count.numpy(), np.asarray(jst.count))
        for a, b in ((tst.o, jst.o), (tst.d, jst.d), (tst.kr, jst.kr)):
            np.testing.assert_array_equal(tv3.to_aos(a).numpy(),
                                          np.asarray(jv3.to_aos(b)))
        np.testing.assert_array_equal(tst.remaining.numpy(),
                                      np.asarray(jst.remaining))
        np.testing.assert_array_equal(tst.inside.numpy(),
                                      np.asarray(jst.inside))
    assert drops > 0 and int(tst.count.max()) == S   # overflow was dropped


def test_tint_from_counts():
    """Π kt^count against the running product, and its gradient
    count·kt^(count-1) (zero for a zero count, also where kt is 0)."""
    kt = torch.tensor([[0.5, 0.0, 0.9], [0.2, 0.3, 0.4], [0.7, 0.8, 0.6]],
                      requires_grad=True)
    slots = (0, 2)
    counts = torch.tensor([[0, 0], [1, 0], [3, 2], [0, 5]],
                          dtype=torch.int16)
    tint = TG.tint_from_counts(kt, slots, counts)
    want = np.ones((4, 3), np.float32)
    k = kt.detach().numpy()
    for r, (a, b) in enumerate(counts.tolist()):
        for _ in range(a):
            want[r] *= k[0]
        for _ in range(b):
            want[r] *= k[2]
    np.testing.assert_allclose(tv3.to_aos(tint).detach().numpy(), want,
                               rtol=1e-6)
    sum(c.sum() for c in tint).backward()
    g = kt.grad.numpy()
    assert np.all(np.isfinite(g)) and not g[1].any()  # no slot: no grad
    n0, n2 = counts[:, 0].numpy(), counts[:, 1].numpy()
    want_g0 = [sum(n0[r] * k[0, c] ** max(n0[r] - 1, 0) * k[2, c] ** n2[r]
                   for r in range(4)) for c in range(3)]
    np.testing.assert_allclose(g[0], want_g0, rtol=1e-5)


def _union_inputs(seed=26, P=96, lc=6, nchunks=2):
    """Pixel origins among the soup and segments to its sphere."""
    return _shadow_inputs(seed, P=P, lc=lc, nchunks=nchunks)


@pytest.mark.parametrize("V,ties", [(8, False), (48, False), (8, True)])
def test_shadow_union_visit_order_matches_jax(V, ties):
    """The union lists (both branches of ``_k_smallest``: V <= 32 and
    V > 32): ok, spill, and cids on ok slots equal; with ``ties``, the
    first clusters are copies of one cluster (equal centre distances: the
    lowest id first)."""
    jcs, tcs = packs(True)
    origin, dirs, dist, _, _ = _union_inputs()
    nchunks = dirs.shape[0]

    def jf(i):
        return jnp.asarray(dirs[i]), jnp.asarray(dist[i]), None

    def tf(i):
        return t(dirs[i]), t(dist[i]), None
    if ties:
        # the cluster most often listed first, copied onto ids 0, 1 and 2
        c0, _, _ = TT.shadow_union_visit_order(tcs, t(origin), tf, nchunks,
                                               V)
        top = int(np.bincount(c0[:, 0].numpy()).argmax())
        tied = sorted({0, 1, 2, top})
        lo, hi = np.asarray(jcs.lo).copy(), np.asarray(jcs.hi).copy()
        lo[tied], hi[tied] = lo[top], hi[top]
        jcs = dataclasses.replace(jcs, lo=jnp.asarray(lo), hi=jnp.asarray(hi))
        tcs = dataclasses.replace(tcs, lo=t(lo), hi=t(hi))
    jc, jok, jsp = JT.shadow_union_visit_order(jcs, jnp.asarray(origin), jf,
                                               nchunks, V)
    cids, ok, spill = TT.shadow_union_visit_order(tcs, t(origin), tf,
                                                  nchunks, V)
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jok))
    np.testing.assert_array_equal(spill.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(cids.numpy()[ok], np.asarray(jc)[ok])
    assert ok.any()
    if V == 8:
        assert spill.max() > 0                          # truncated lists
    else:
        assert not ok.all()
    if ties:
        # equal centre distances: the copies sit together, lowest id first
        c = cids.numpy()
        rows = [r for r in range(len(ok)) if (c[r][ok[r]] == tied[0]).any()]
        assert rows
        whole = 0
        for r in rows:
            pos = np.flatnonzero(np.isin(c[r], tied) & ok[r])
            assert (np.diff(pos) == 1).all()       # the list may cut them
            assert (np.diff(c[r][pos]) > 0).all()
            whole += len(pos) == len(tied)
        assert whole > 0


@pytest.fixture(scope="module")
def union_intersectors():
    jsc, tsc, jds, tds = _soup_scenes()
    kw = dict(bvh_shadow_cluster=16, light_chunk=6)
    jix = jax_make_intersector(jds, jsc.static, JaxConfig(**kw))
    tix = make_intersector(tds, tsc.static, RenderConfig(**kw))
    assert tix.resolved_shadow_mode == jix.resolved_shadow_mode == "union"
    return jix, tix


def _query(ix, v3mod, conv, origin, dirs, dist, egid=0, **kw):
    def dirs_fn(i):
        return (v3mod.from_aos(conv(dirs[i].transpose(1, 0, 2).copy())),
                conv(dist[i].T.copy()))
    lo, hi = ix.emitter_bounds(egid)
    return ix.shadow_query(v3mod.from_aos(conv(origin)), lo, hi, dirs_fn,
                           egid, dirs.shape[0], dirs.shape[2], **kw)


def test_union_shadow_query_matches_jax(union_intersectors):
    """The union ``shadow_query`` of the transparent soup with its kt tint:
    the light that passes, where(blocked, 0, tint), within rtol 1e-6 of the
    JAX package's, blocked and the spill equal."""
    jix, tix = union_intersectors
    origin, dirs, dist, _, _ = _union_inputs()
    jb, jtn, jsp = _query(jix, jv3, jnp.asarray, origin, dirs, dist)
    tb, counts, sp = _query(tix, tv3, t, origin, dirs, dist)
    assert tb.shape == (2, 6, 96) and counts.shape == (2, 6, 96, 1)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(sp) == int(jsp)
    tint = tv3.to_aos(tix.tint(counts)).numpy()
    jt_ = np.stack([np.asarray(c) for c in jtn], -1)
    np.testing.assert_allclose(np.where(tb.numpy()[..., None], 0, tint),
                               np.where(np.asarray(jb)[..., None], 0, jt_),
                               rtol=1e-6)
    assert (counts > 0).float().mean() > 0.05 and counts.max() > 1


@pytest.mark.parametrize("opts", [dict(union_scope="chunk"),
                                  dict(union_compact="on"),
                                  dict(union_compact="off"),
                                  dict(union_scope="frame",
                                       union_compact="on")])
def test_union_options_give_the_same_occlusion(opts, union_intersectors):
    """Frame and chunk scope, compaction on and off: blocked, counts and
    spill bit-identical; with ``live`` the live pixels' results too."""
    _, tix = union_intersectors
    origin, dirs, dist, _, _ = _union_inputs()
    ref = _query(tix, tv3, t, origin, dirs, dist)
    ix = dataclasses.replace(tix, cfg=dataclasses.replace(tix.cfg, **opts))
    live = torch.from_numpy(np.arange(96) % 3 != 0)
    for kw in ({}, dict(live=live)):
        out = _query(ix, tv3, t, origin, dirs, dist, **kw)
        m = live if kw else slice(None)
        assert torch.equal(out[0][..., m], ref[0][..., m])
        assert torch.equal(out[1][..., m, :], ref[1][..., m, :])
        assert int(out[2]) == int(ref[2])


@pytest.mark.parametrize("route", [dict(accel="none"),
                                   dict(shadow_mode="per_ray"), {}])
def test_direct_light_takes_the_tint(route, monkeypatch):
    """Direct light multiplies each sample by its kt tint on every shadow
    route (dense, per-ray clusters, union): the soup's frame changes when
    the tint is dropped, and the sweeps run no more than once."""
    _, tsc = glass_soup()
    cfg = RenderConfig(max_bounces=1, light_chunk=8, **route)
    fn = make_renderer(tsc.static, cfg, 12, 12, device="cpu")
    img, _ = fn(tsc.params, PhiloxSampler(4, "cpu"))
    monkeypatch.setattr(intersect.Intersector, "tint",
                        lambda self, counts: tv3.full(counts.shape[:-1], 1.0,
                                                      device="cpu"))
    dropped, _ = fn(tsc.params, PhiloxSampler(4, "cpu"))
    assert float((dropped - img).max()) > 1e-3 * float(img.max())
    assert float((dropped - img).min()) >= 0       # kt < 1 only dims

"""The port's mesh acceleration against the JAX package's, on the same NumPy
inputs: Morton build, cluster packing, the visit order (kernel 3's plain
version, against both the XLA body and the Pallas kernel in interpret
mode), the cluster sweeps, the shared-origin shadow sweeps and the
intersector's dense and cluster triangle routes.

The scenes are the 600-triangle soup of tests/test_accel.py: with a
transparent triangle material (the kt layout, 17 packed rows) or an opaque
one (13 rows).

The JAX side runs op by op (``jax.disable_jit``, for every test but the
Pallas one): compiled, XLA contracts the a·b − c·d products of
``jnp.cross`` and of Möller-Trumbore inside ``lax.scan`` bodies into FMAs,
which moves normals and hit distances by ulps; the port, like every eager
JAX op, rounds each product.  Tolerances: selections (ids, masks, spill
counts) and packed tables exact; hit distances and tints rtol 1e-6 (the
same float32 operations in the same order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.accel import build as JB
from c_raytracer_tpu.accel import make_intersector as jax_make_intersector
from c_raytracer_tpu.accel import pallas_visit as JPV
from c_raytracer_tpu.accel import traverse as JT
from c_raytracer_tpu.core import v3 as jv3
from c_raytracer_tpu.geometry import primitives as JG
from c_raytracer_tpu.render.config import RenderConfig as JaxConfig
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import build as TB
from c_raytracer_tpu_torch.accel import make_intersector, pallas_visit
from c_raytracer_tpu_torch.accel import traverse as TT
from c_raytracer_tpu_torch.core import v3 as tv3
from c_raytracer_tpu_torch.geometry import primitives as TG
from c_raytracer_tpu_torch.render.config import RenderConfig
from c_raytracer_tpu_torch.scene import make_scene, params_to_torch

pytest_plugins = ("torch_harness",)

FLT_MAX = float(np.finfo(np.float32).max)
R = 300          # rays per query: one shape, so op-by-op JAX compiles once


@pytest.fixture(autouse=True)
def _jax_op_by_op():
    with jax.disable_jit():
        yield


def soup_kwargs(seed=0, nt=600, transparent=True):
    """make_scene arguments of the triangle soup of tests/test_accel.py."""
    rng = np.random.default_rng(seed)
    tv = rng.uniform(-3, 3, (nt, 3, 3)).astype(np.float32)
    tv[:, 1:] = tv[:, :1] + rng.uniform(-0.4, 0.4, (nt, 2, 3)).astype(
        np.float32)
    return dict(
        sphere_center=[[0.0, 0.0, 0.0]], sphere_radius=[0.5],
        sphere_material=[0],
        tri_vertices=tv, tri_material=[1] * nt,
        plane_point=[[0, -4, 0]], plane_normal=[[0, 1, 0]],
        plane_material=[0],
        materials=[
            dict(ks=[1, 1, 1], ka=[.1, .1, .1], tex_color=[1, 1, 1]),
            dict(ks=[1, 1, 1], kt=[.5, .6, .7] if transparent else [0] * 3,
                 tex_color=[1, 1, 1]),
        ],
        camera=dict(position=[0, 0, -8], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=60, focal_length=1))


@functools.lru_cache(maxsize=None)
def soup(transparent=True, seed=0):
    """(JAX scene, port scene), both Morton-ordered."""
    kw = soup_kwargs(seed, transparent=transparent)
    from c_raytracer_tpu.accel import reorder_scene as jax_reorder
    from c_raytracer_tpu_torch.accel import reorder_scene
    return jax_reorder(jax_make_scene(**kw)), reorder_scene(make_scene(**kw))


def rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@functools.lru_cache(maxsize=None)
def packs(transparent, C=16, seed=0):
    """(JAX ClusterSet, port ClusterSet) of the soup, packed at C."""
    jsc, tsc = soup(transparent, seed)
    jds = JG.device_scene(jsc.params, jsc.static)
    jcs = JT.pack_clusters(jds, jsc.static, C)
    tds = TG.device_scene(params_to_torch(tsc.params, "cpu"), tsc.static)
    return jcs, TT.pack_clusters(tds, tsc.static, C)


def t(x):
    return torch.from_numpy(np.array(x))


# -- Morton build -----------------------------------------------------------

def test_morton_codes_and_order_match_jax():
    rng = np.random.default_rng(7)
    cen = rng.uniform(-10, 10, (5000, 3)).astype(np.float32)
    cen[:7] = cen[7]                                  # equal codes: stable
    np.testing.assert_array_equal(TB.morton_codes_np(cen),
                                  JB.morton_codes_np(cen))
    tv = np.asarray(soup_kwargs(3)["tri_vertices"])
    np.testing.assert_array_equal(TB.morton_order(tv), JB.morton_order(tv))
    np.testing.assert_array_equal(TB.expand_bits_np(np.arange(1024)),
                                  JB.expand_bits_np(np.arange(1024)))


@pytest.mark.parametrize("transparent", [True, False])
def test_reorder_scene_matches_jax(transparent):
    kw = soup_kwargs(4, nt=300, transparent=transparent)
    kw["tri_lights"] = [0] * 299 + [8]                # a triangle emitter
    from c_raytracer_tpu.accel import reorder_scene as jax_reorder
    from c_raytracer_tpu_torch.accel import reorder_scene
    a, b = reorder_scene(make_scene(**kw)), jax_reorder(jax_make_scene(**kw))
    assert dataclasses.asdict(a.static) == dataclasses.asdict(b.static)
    np.testing.assert_array_equal(a.params.tri_vertices,
                                  np.asarray(b.params.tri_vertices))
    assert a.static.emitter_prims != (1 + 299,)       # the emitter moved


# -- cluster packing --------------------------------------------------------

@pytest.mark.parametrize("transparent", [True, False])
def test_pack_clusters_matches_jax(transparent):
    jcs, tcs = packs(transparent)
    assert tcs.has_transp == jcs.has_transp == transparent
    assert tcs.blk.shape == (38, 17 if transparent else 13, 16)
    assert tcs.gid0 == int(jcs.gid0)
    for name in ("blk", "lo", "hi", "flat", "bound"):
        np.testing.assert_array_equal(getattr(tcs, name).numpy(),
                                      np.asarray(getattr(jcs, name)),
                                      err_msg=name)


# -- kernel 3: the visit order ----------------------------------------------

@pytest.mark.parametrize("with_max_dist", [False, True])
@pytest.mark.parametrize("V", [4, 16, 64])
def test_visit_order_reference_matches_jax(V, with_max_dist):
    """The plain version against the XLA body of ``_visit_order`` at
    R = 300, K = 75 (C = 8): equal ok, spill, and cids and entry on ok
    slots.  The spill is the exact overlap count beyond V, the truncation
    guard the JAX kernel route reports as 0."""
    jcs, tcs = packs(False, C=8)
    o, d = rays(5, R)
    md = np.random.default_rng(6).uniform(0.5, 6, R).astype(np.float32)
    cmd = md if with_max_dist else None
    jc, jok, je, jsp = JT._visit_order(
        jcs, jnp.asarray(o), jnp.asarray(d), V,
        count_max_dist=None if cmd is None else jnp.asarray(cmd))
    K = tcs.lo.shape[0]
    assert K == 75
    cids, ok, entry, spill = TT._visit_order(
        tcs, t(o), t(d), V, count_max_dist=None if cmd is None else t(cmd))
    assert cids.shape == (R, V)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(spill.numpy(), np.asarray(jsp))
    m = ok.numpy()
    np.testing.assert_array_equal(cids.numpy()[m], np.asarray(jc)[m])
    np.testing.assert_array_equal(entry.numpy()[m], np.asarray(je)[m])
    assert np.all(entry.numpy()[~m] == FLT_MAX)
    if V == 4:
        assert spill.max() > 0        # the guard sees truncation
    # the wrapper sends CPU tensors to the plain version
    k = pallas_visit.visit_order(t(o), t(d), tcs.lo, tcs.hi, V,
                                 None if cmd is None else t(cmd))
    assert torch.equal(k[2], spill)


def test_visit_order_reference_matches_pallas_interpret():
    """The plain version against the TPU kernel itself, run in interpret
    mode as tests/test_accel.py runs it (K padded to a lane multiple with
    never-overlapping +inf boxes)."""
    jcs, tcs = packs(True)
    K = tcs.lo.shape[0]
    o, d = rays(5, 256)
    Kp = -(-K // 128) * 128
    inf = jnp.full((Kp - K, 3), np.float32(np.inf))
    with jax.disable_jit(False):        # pallas_call needs its tracing
        jc, je = JPV.visit_order_fused(
            jnp.asarray(o), jnp.asarray(d), jnp.concatenate([jcs.lo, inf]),
            jnp.concatenate([jcs.hi, inf]), V=16, interpret=True)
    cids, entry, spill = pallas_visit.visit_order_reference(
        t(o), t(d), tcs.lo, tcs.hi, 16)
    ok = entry.numpy() < FLT_MAX
    np.testing.assert_array_equal(ok, np.asarray(je) < JPV.FLT_MAX)
    np.testing.assert_array_equal(cids.numpy()[ok], np.asarray(jc)[ok])
    np.testing.assert_array_equal(entry.numpy()[ok], np.asarray(je)[ok])
    assert spill.max() > 0


def test_visit_order_wrapper_checks():
    _, tcs = packs(False)
    o, d = rays(1, 10)
    with pytest.raises(ValueError, match="V=39"):
        pallas_visit.visit_order(t(o), t(d), tcs.lo, tcs.hi, 39)
    nan_o = t(o).clone()
    nan_o[0, 1] = float("nan")
    _, entry, spill = pallas_visit.visit_order(nan_o, t(d), tcs.lo,
                                               tcs.hi, 4)
    assert bool((entry[0] == FLT_MAX).all()) and int(spill[0]) == 0


# -- the cluster sweeps -----------------------------------------------------

def _best0(R):
    return ((jnp.full((R,), JT.FLT_MAX), jnp.full((R,), -1, jnp.int32),
             jnp.zeros((R, 3), jnp.float32)),
            (torch.full((R,), FLT_MAX), torch.full((R,), -1, dtype=torch.long),
             torch.zeros((R, 3))))


@pytest.mark.parametrize("dead_skip", [False, True])
def test_closest_hit_clusters_matches_jax(dead_skip):
    jcs, tcs = packs(False)
    o, d = rays(11, R)
    jb, tb = _best0(R)
    jt_, jg, jn, jsp = JT.closest_hit_clusters(
        jcs, jnp.asarray(o), jnp.asarray(d), jb, visits=16, with_spill=True)
    bt, bg, bn, sp = TT.closest_hit_clusters(
        tcs, t(o), t(d), tb, visits=16, dead_skip=dead_skip, with_spill=True)
    jg = np.asarray(jg)
    assert (jg >= 0).mean() > 0.05 and (jg < 0).any()
    np.testing.assert_array_equal(bg.numpy(), jg)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_allclose(bt.numpy(), np.asarray(jt_), rtol=1e-6)
    np.testing.assert_array_equal(bn.numpy(), np.asarray(jn))


def soup_tint(counts):
    """The port's (..., 3) tint of blocker counts on the transparent soup,
    the JAX package's tint product's counterpart."""
    _, tsc = soup(True)
    kt = torch.from_numpy(np.asarray(tsc.params.materials.kt))
    return tv3.to_aos(TG.tint_from_counts(kt, TG.tint_slots(tsc.static),
                                          counts))


@pytest.mark.parametrize("transparent", [True, False])
def test_any_hit_tint_clusters_matches_jax(transparent):
    """The per-ray sweep: blocked equal; on the kt soup the port's blocker
    counts give the JAX package's tint product within rtol 1e-6."""
    jcs, tcs = packs(transparent)
    o, d = rays(12, R)
    md = np.random.default_rng(13).uniform(0.5, 8, R).astype(np.float32)
    ex = np.where(np.arange(R) % 3 == 0, 1 + np.arange(R) % 600,
                  -1).astype(np.int32)
    jacc = (jnp.zeros(R, bool), jnp.ones((R, 3), jnp.float32))
    (jbl, jtn), jsp = JT.any_hit_tint_clusters(
        jcs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(md),
        jnp.asarray(ex), jacc, visits=16, with_spill=True)
    tacc = torch.zeros(R, dtype=torch.bool)
    if transparent:
        tacc = (tacc, torch.zeros((R, tcs.n_slots), dtype=torch.int16))
    acc, sp = TT.any_hit_tint_clusters(
        tcs, t(o), t(d), t(md), t(ex).long(), tacc, visits=16,
        dead_skip=transparent, with_spill=True)
    bl = acc[0] if transparent else acc
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jbl))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    if transparent:
        tn = soup_tint(acc[1]).numpy()
        np.testing.assert_allclose(tn, np.asarray(jtn), rtol=1e-6)
        assert (tn < 1).any() and acc[1].max() > 1
    else:
        assert bl.any() and not bl.all()


def _shadow_inputs(seed, P=128, lc=8, nchunks=2):
    """Pixel origins and every chunk's segments to points on the sphere
    emitter (the shared-origin contract), as (P, lc, ...) arrays."""
    jsc, _ = soup(False)
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    c = np.asarray(jsc.params.sphere_center[0])
    r = float(np.asarray(jsc.params.sphere_radius[0]))
    pts = c + rng.uniform(-r, r, (nchunks, P, lc, 3)).astype(np.float32)
    seg = pts - origin[None, :, None]
    dist = np.linalg.norm(seg, axis=-1).astype(np.float32)
    dirs = (seg / dist[..., None]).astype(np.float32)
    lo = (c - r).astype(np.float32)
    hi = (c + r).astype(np.float32)
    return origin, dirs, dist, lo, hi


def test_shadow_visit_order_matches_jax():
    jcs, tcs = packs(False)
    origin, _, _, lo, hi = _shadow_inputs(14)
    jc, jok = JT.shadow_visit_order(jcs, jnp.asarray(origin),
                                    jnp.asarray(lo), jnp.asarray(hi), 38)
    cids, ok = TT.shadow_visit_order(tcs, t(origin), t(lo), t(hi), 38)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    m = ok.numpy()
    assert m.any() and not m.all()
    np.testing.assert_array_equal(cids.numpy()[m], np.asarray(jc)[m])


def _dirs_fns(dirs, dist, egid=0):
    def jf(i):
        return (jnp.asarray(dirs[i]), jnp.asarray(dist[i]),
                jnp.full(dist[i].shape, egid, jnp.int32))

    def tf(i):
        return t(dirs[i]), t(dist[i]), torch.full(dist[i].shape, egid)
    return jf, tf


@pytest.mark.parametrize("what", ["shortlist", "sweep_opaque",
                                  "shared_opaque", "shared_kt"])
def test_shared_shadow_sweeps_match_jax(what):
    """shadow_shortlist, any_hit_tint_shortlist and any_hit_tint_shared
    (the bvh_shadow_shortlist=0 route) on the same visit lists."""
    transparent = what == "shared_kt"
    jcs, tcs = packs(transparent)
    origin, dirs, dist, lo, hi = _shadow_inputs(15)
    P, nchunks, lc = origin.shape[0], dirs.shape[0], dirs.shape[2]
    jc, jok = JT.shadow_visit_order(jcs, jnp.asarray(origin),
                                    jnp.asarray(lo), jnp.asarray(hi), 16)
    tc, tok = t(jc).long(), t(jok)
    jo, to = jnp.asarray(origin), t(origin)
    jf, tf = _dirs_fns(dirs, dist)
    jb0 = jnp.zeros((P, nchunks, lc), bool)
    tb0 = torch.zeros((P, nchunks, lc), dtype=torch.bool)
    if what in ("shortlist", "sweep_opaque"):
        ec = 0.5 * (lo + hi)
        er = np.float32(0.5) * np.float32(np.linalg.norm(hi - lo))
        jblk, jgid, jlok = JT.shadow_shortlist(jcs, jo, jc, jok,
                                               jnp.asarray(ec),
                                               jnp.asarray(er), 32)
        blk, gid, lok = TT.shadow_shortlist(tcs, to, tc, tok, t(ec),
                                            torch.tensor(er), 32)
        np.testing.assert_array_equal(lok.numpy(), np.asarray(jlok))
        m = lok.numpy()
        assert m.any() and not m.all()
        np.testing.assert_array_equal(gid.numpy()[m], np.asarray(jgid)[m])
        np.testing.assert_array_equal(
            blk.numpy().transpose(0, 2, 1)[m],
            np.asarray(jblk).transpose(0, 2, 1)[m])
        if what == "shortlist":
            return
        jacc = JT.any_hit_tint_shortlist(jcs, jo, jblk, jgid, jlok, jf,
                                         nchunks, jb0, remat=False)
        acc = TT.any_hit_tint_shortlist(tcs, to, t(jblk), t(jgid).long(),
                                        t(jlok), tf, nchunks, tb0)
        assert acc.any() and not acc.all()
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        return
    if transparent:
        jacc0 = (jb0, jnp.ones((P, nchunks, lc, 3), jnp.float32))
        tacc0 = (tb0, torch.zeros((P, nchunks, lc, tcs.n_slots),
                                  dtype=torch.int16))
    else:
        jacc0, tacc0 = jb0, tb0
    jacc = JT.any_hit_tint_shared(jcs, jo, jc, jok, jf, nchunks, jacc0,
                                  remat=False)
    acc = TT.any_hit_tint_shared(tcs, to, tc, tok, tf, nchunks, tacc0,
                                 dead_skip=True)
    if transparent:
        np.testing.assert_array_equal(acc[0].numpy(), np.asarray(jacc[0]))
        tn = soup_tint(acc[1]).numpy()
        np.testing.assert_allclose(tn, np.asarray(jacc[1]), rtol=1e-6)
        assert (tn < 1).any()
    else:
        assert acc.any() and not acc.all()
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


# -- the intersector --------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(shadow_mode="union"),
                                dict(bvh_visits=8, bvh_shadow_visits=24,
                                     bvh_shadow_shortlist=0,
                                     bvh_shadow_cluster=32, rounds=3,
                                     bvh_super_group=8)])
def test_resolved_policies_match_jax(kw):
    port, ref = RenderConfig(**kw), JaxConfig(**kw)
    for tr in (False, True):
        for name in ("shadow_mode", "shadow_cluster", "union_visits",
                     "visits", "shadow_visits", "shadow_shortlist",
                     "rounds"):
            assert (getattr(port, f"resolved_{name}")(tr)
                    == getattr(ref, f"resolved_{name}")(tr)), (name, tr)
        assert (port.resolved_super_group(tr, 100)
                == ref.resolved_super_group(tr, 100))


@functools.lru_cache(maxsize=None)
def _intersectors_cached(transparent, kw_items):
    return _build_intersectors(transparent, **dict(kw_items))


def _intersectors(transparent, **kw):
    return _intersectors_cached(transparent, tuple(sorted(kw.items())))


def _build_intersectors(transparent, **kw):
    jsc, tsc = soup(transparent)
    jds = JG.device_scene(jsc.params, jsc.static)
    jix = jax_make_intersector(jds, jsc.static, JaxConfig(**kw))
    tds = TG.device_scene(params_to_torch(tsc.params, "cpu"), tsc.static)
    return jix, make_intersector(tds, tsc.static, RenderConfig(**kw))


@pytest.mark.parametrize("route", [
    dict(accel="none"),
    dict(accel="auto", bvh_ray_chunk=700),     # clusters, two ray slices
])
def test_intersector_closest_matches_jax(route):
    jix, tix = _intersectors(False, **route)
    assert tix.has_clusters == (route["accel"] == "auto")
    o, d = rays(16, R)
    jt_, jg, jm, jn, jsp = jix.closest(jv3.from_aos(jnp.asarray(o)),
                                       jv3.from_aos(jnp.asarray(d)),
                                       with_spill=True)
    bt, bg, bm, bn, sp = tix.closest(tv3.from_aos(t(o)), tv3.from_aos(t(d)),
                                     with_spill=True)
    jg = np.asarray(jg)
    assert 601 in jg and ((jg >= 1) & (jg <= 600)).any()  # plane, triangles
    np.testing.assert_array_equal(bg.numpy(), jg)
    np.testing.assert_array_equal(bm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_allclose(bt.numpy(), np.asarray(jt_), rtol=1e-6)
    np.testing.assert_allclose(tv3.to_aos(bn).numpy(),
                               np.asarray(jv3.to_aos(jn)), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("route", [
    dict(accel="none"),
    dict(accel="auto", shadow_mode="per_ray"),
])
def test_intersector_any_tint_matches_jax(route):
    """(lc, P) sample directions against (1, P) origins, kt soup: blocked
    and spill equal, the tint formed from the port's blocker counts within
    rtol 1e-6 of the JAX package's tint product."""
    jix, tix = _intersectors(True, **route)
    o, d = rays(17, R)
    o = o[:75][None]                                  # (1, P, 3)
    d = d.reshape(4, 75, 3)
    md = np.random.default_rng(18).uniform(0.5, 8, (4, 75)).astype(
        np.float32)
    jb, jtn, jsp = jix.any_tint(jv3.from_aos(jnp.asarray(o)),
                                jv3.from_aos(jnp.asarray(d)),
                                jnp.asarray(md), 3, with_spill=True)
    bl, counts, sp = tix.any_counts(tv3.from_aos(t(o)), tv3.from_aos(t(d)),
                                    t(md), 3, with_spill=True)
    tn = tix.tint(counts)
    assert bl.shape == (4, 75)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tv3.to_aos(tn).numpy(),
                               np.asarray(jv3.to_aos(jtn)), rtol=1e-6)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    assert (tv3.to_aos(tn).numpy() < 1).any()


@pytest.mark.parametrize("shortlist", [32, 0])
def test_intersector_shadow_query_matches_jax(shortlist):
    jix, tix = _intersectors(False, bvh_shadow_shortlist=shortlist)
    assert tix.use_shared_shadows and jix.use_shared_shadows
    origin, dirs, dist, _, _ = _shadow_inputs(19)
    egid = 0
    jlo, jhi = jix.emitter_bounds(egid)
    tlo, thi = tix.emitter_bounds(egid)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))

    # the query takes (lc, P) SoA chunks
    def jdirs(i):
        return (jv3.from_aos(jnp.asarray(dirs[i].transpose(1, 0, 2))),
                jnp.asarray(dist[i].T))

    def tdirs(i):
        return (tv3.from_aos(t(dirs[i].transpose(1, 0, 2).copy())),
                t(dist[i].T.copy()))
    jb, jtn, jsp = jix.shadow_query(jv3.from_aos(jnp.asarray(origin)), jlo,
                                    jhi, jdirs, egid, 2, 8)
    bl, tn, sp = tix.shadow_query(tv3.from_aos(t(origin)), tlo, thi, tdirs,
                                  egid, 2, 8)
    assert tn is None and jtn is None and bl.shape == (2, 8, 128)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jb))
    assert int(sp) == int(jsp) == 0
    assert bl.any() and not bl.all()


# -- the plane-id fault -----------------------------------------------------

def test_plane_gid_follows_triangles():
    """Global ids run spheres, triangles, planes: a plane winner is
    ``ns + nt + i`` and takes the plane's material, with triangles in the
    scene (the port once numbered planes from ``ns``)."""
    kw = dict(
        sphere_center=[[0, 5, 0]], sphere_radius=[0.5], sphere_material=[0],
        tri_vertices=[[[-1, -1, 2], [1, -1, 2], [0, 1, 2]],
                      [[-1, -1, 9], [1, -1, 9], [0, 1, 9]]],
        tri_material=[1, 1],
        plane_point=[[0, -3, 0], [0, 0, 30]],
        plane_normal=[[0, 1, 0], [0, 0, -1]], plane_material=[2, 3],
        plane_epsilon=[1e-3, 1e-2],
        materials=[dict(ke=[1, 1, 1]), dict(ks=[1, 1, 1]),
                   dict(ks=[0.5] * 3), dict(ks=[0.2] * 3)],
        camera=dict(position=[0, 0, -5], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=60, focal_length=1))
    jsc, tsc = jax_make_scene(**kw), make_scene(**kw)
    o = np.zeros((5, 3), np.float32)
    d = np.array([[0, 0, 1], [0, -1, 0], [0.5, 0.05, 1], [0, 1, 0],
                  [1, 0, 0]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jds = JG.device_scene(jsc.params, jsc.static)
    tds = TG.device_scene(params_to_torch(tsc.params, "cpu"), tsc.static)
    np.testing.assert_array_equal(tds.pln_eps.numpy(), np.asarray(jds.pln_eps))
    jt_, jg, jm, _ = JG.closest_hit_soa(jds, jsc.static,
                                        jv3.from_aos(jnp.asarray(o)),
                                        jv3.from_aos(jnp.asarray(d)))
    bt, bg, bm, _ = TG.closest_hit_soa(tds, tsc.static, tv3.from_aos(t(o)),
                                       tv3.from_aos(t(d)))
    assert bg.tolist() == [1, 3, 4, 0, -1]            # tri, plane 0, 1, sph
    np.testing.assert_array_equal(bg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(bm.numpy(), np.asarray(jm))
    assert bm.tolist()[:4] == [1, 2, 3, 0]
    np.testing.assert_allclose(bt.numpy(), np.asarray(jt_), rtol=1e-6)
    blocked, _ = TG.any_hit_counts_soa(tds, tsc.static, tv3.from_aos(t(o)),
                                       tv3.from_aos(t(d)),
                                       torch.full((5,), 1e3),
                                       torch.full((5,), 3))
    assert blocked.tolist() == [True, False, True, True, False]

"""The port's primitive-range shards (geometry/sharded.py, the sharded
routes of accel/intersect.py, ``traverse.pack_clusters_sharded``) against
the JAX package's stacked form (``sharding=None``: every shard in one
process, which tests/test_parallel.py holds equal to its SPMD form), on
the lit soup of tests/test_parallel.py and the soup of tests/test_accel.py.

Held exact: the shard layout (chunk, shard length, pad rows, ids, kt
rows), the packed cluster tables, the closest hits (t, id, material,
normal) and the ``blocked`` masks, against JAX and against the port's own
unsharded fold, and the blocker counts against the unsharded fold.  The
re-test's hit distances and normals are held at rtol 1e-6 against JAX, as
tests/test_torch_accel.py holds the unsharded ones, and the tint formed
from the port's counts within 1e-6 of JAX's ordered kt product over
shards (its own tolerance, tests/test_parallel.py).

The JAX side runs op by op (``jax.disable_jit``), as in the other port
tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.accel import make_intersector as jax_make_intersector
from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.accel import traverse as JT
from c_raytracer_tpu.core import v3 as jv3
from c_raytracer_tpu.geometry import primitives as JG
from c_raytracer_tpu.geometry import sharded as JS
from c_raytracer_tpu.render.config import RenderConfig as JaxConfig
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import make_intersector, reorder_scene
from c_raytracer_tpu_torch.accel import traverse as TT
from c_raytracer_tpu_torch.core import v3 as tv3
from c_raytracer_tpu_torch.geometry import primitives as TG
from c_raytracer_tpu_torch.geometry import sharded as TS
from c_raytracer_tpu_torch.render.config import RenderConfig
from c_raytracer_tpu_torch.scene import make_scene, params_to_torch
from test_torch_distributed import lit_kwargs

R = 257   # rays per query


@pytest.fixture(autouse=True)
def _jax_op_by_op():
    with jax.disable_jit():
        yield


@functools.lru_cache(maxsize=None)
def scenes(transparent=True):
    """(JAX DeviceScene, JAX static, port DeviceScene, port static) of the
    lit soup, Morton-ordered."""
    kw = lit_kwargs(transparent=transparent)
    j = jax_reorder(jax_make_scene(**kw))
    p = reorder_scene(make_scene(**kw))
    return (JG.device_scene(j.params, j.static), j.static,
            TG.device_scene(params_to_torch(p.params, "cpu"), p.static),
            p.static)


def rays(seed, n=R):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def jv(a):
    return jv3.from_aos(jnp.asarray(a))


def tv(a):
    return tv3.from_aos(torch.from_numpy(a))


def npy(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def v3_equal(a, b):
    for c in "xyz":
        np.testing.assert_array_equal(npy(getattr(a, c)), npy(getattr(b, c)))


def v3_close(a, b, rtol=1e-6):
    for c in "xyz":
        np.testing.assert_allclose(npy(getattr(a, c)), npy(getattr(b, c)),
                                   rtol=rtol, atol=0)


@pytest.mark.parametrize("S,chunk", [(4, 512), (3, 96), (8, 2048)])
def test_shard_layout_matches_jax(S, chunk):
    jds, jst, tds, tst = scenes()
    js = JS.shard_triangles(jds, jst, S, tri_chunk=chunk)
    ts = TS.shard_triangles(tds, tst, S, tri_chunk=chunk)
    assert ts.chunk == js.chunk and ts.m == js.eps.shape[1]
    assert ts.n_local == S and ts.first == 0 and ts.group is None
    for f in ("v0", "e1", "e2", "n"):
        v3_equal(getattr(ts, f), getattr(js, f))
    for f in ("eps", "mat", "gid", "kt", "transp"):
        np.testing.assert_array_equal(npy(getattr(ts, f)),
                                      npy(getattr(js, f)), err_msg=f)
    assert (npy(ts.gid) == -1).sum() == S * ts.m - tst.n_triangles
    assert (npy(ts.eps)[npy(ts.gid) < 0] == 1.0).all()
    # an owned shard is the same slice of the replicated tensors
    for k in range(S):
        own = TS.shard_triangles(tds, tst, S, tri_chunk=chunk, owned=k,
                                 group="pr")
        assert own.n_local == 1 and own.first == k and own.group == "pr"
        for f in ("eps", "gid", "kt"):
            np.testing.assert_array_equal(npy(getattr(own, f))[0],
                                          npy(getattr(ts, f))[k])
        v3_equal(own.v0.map(lambda a: a[0]), ts.v0.map(lambda a: a[k]))
    with pytest.raises(ValueError):
        TS.shard_triangles(tds, tst, S, owned=0)   # no group


@pytest.mark.parametrize("transparent,C", [(True, 16), (True, 64),
                                           (False, 16)])
def test_pack_clusters_sharded_matches_jax(transparent, C):
    """Each shard's pack bit for bit as JAX's, for the clusters that hold
    a triangle.  JAX also packs the clusters of pad rows only, whose boxes
    are inverted (lo > hi): the slab test overlaps such a box at entry 0
    on every ray.  The port leaves them out (a shard without a triangle
    packs nothing)."""
    jds, jst, tds, tst = scenes(transparent)
    js = JS.shard_triangles(jds, jst, 4, tri_chunk=512)
    ts = TS.shard_triangles(tds, tst, 4, tri_chunk=512)
    jcs = JT.pack_clusters_sharded(js, jst, C)
    tcs = TT.pack_clusters_sharded(ts, tst, C)
    assert len(tcs) == 4 and tcs[3] is None     # 600 = 256 + 256 + 88
    for k, cs in enumerate(tcs):
        n = max(min(tst.n_triangles - k * ts.m, ts.m), 0)
        K = -(-n // C)
        assert (cs is None) == (K == 0)
        jlo, jhi = npy(jcs.lo[k]), npy(jcs.hi[k])
        assert (jlo[K:] > jhi[K:]).all()        # JAX's pad-only clusters
        if cs is None:
            continue
        assert cs.gid0 == int(jcs.gid0[k]) == tst.n_spheres + k * ts.m
        assert cs.has_transp == transparent
        for f in ("blk", "lo", "hi", "bound"):
            np.testing.assert_array_equal(npy(getattr(cs, f)),
                                          npy(getattr(jcs, f)[k])[:K],
                                          err_msg=f)
        np.testing.assert_array_equal(npy(cs.flat),
                                      npy(jcs.flat[k])[:K * C])


def test_dense_folds_match_jax():
    """The dense range folds (closest hit, shadows) over 4 stacked shards,
    tri_chunk 512 (C = 128, m = 256; shard 3 is all padding)."""
    jds, jst, tds, tst = scenes()
    js = JS.shard_triangles(jds, jst, 4, tri_chunk=512)
    ts = TS.shard_triangles(tds, tst, 4, tri_chunk=512)
    o, d = rays(1)
    jt, jg, jm, jn = JS.closest_hit_sharded(jds, jst, js, jv(o), jv(d))
    tt, tg, tm, tn = TS.closest_hit_sharded(tds, tst, ts, tv(o), tv(d))
    ut, ug, um, un = TG.closest_hit_soa(tds, tst, tv(o), tv(d))
    assert (npy(tg) >= tst.n_spheres).sum() > 10       # triangle winners
    np.testing.assert_array_equal(npy(tg), npy(jg))
    np.testing.assert_array_equal(npy(tm), npy(jm))
    np.testing.assert_array_equal(npy(tt), npy(ut))
    np.testing.assert_array_equal(npy(tg), npy(ug))
    np.testing.assert_array_equal(npy(tm), npy(um))
    v3_equal(tn, un)
    np.testing.assert_array_equal(npy(tt), npy(jt))
    v3_equal(tn, jn)

    md = np.full(R, 5.0, np.float32)
    jb, jtint = JS.any_hit_tint_sharded(jds, jst, js, jv(o), jv(d),
                                        jnp.asarray(md), -1)
    tb, tc = TS.any_hit_counts_sharded(tds, tst, ts, tv(o), tv(d),
                                       torch.from_numpy(md), -1)
    ub, uc = TG.any_hit_counts_soa(tds, tst, tv(o), tv(d),
                                   torch.from_numpy(md), -1)
    assert npy(tb).any() and npy(tc).sum() > 0
    np.testing.assert_array_equal(npy(tb), npy(jb))
    np.testing.assert_array_equal(npy(tb), npy(ub))
    np.testing.assert_array_equal(npy(tc), npy(uc))
    tint = TG.tint_from_counts(tds.materials.kt, TG.tint_slots(tst), tc)
    for c in "xyz":
        np.testing.assert_allclose(npy(getattr(tint, c)),
                                   npy(getattr(jtint, c)), rtol=0, atol=1e-6)


def test_retest_matches_jax():
    """The inside-object re-test of a sharded intersector against JAX's
    through the owner shard, for rays whose gid is a triangle, a sphere, a
    plane or -1: the port reads the replicated tables, the owner shard's
    rows bit for bit."""
    jds, jst, tds, tst = scenes()
    js = JS.shard_triangles(jds, jst, 4, tri_chunk=512)
    ts = TS.shard_triangles(tds, tst, 4, tri_chunk=512)
    rng = np.random.default_rng(3)
    gid = rng.integers(-1, tst.n_prims, 301)
    ns, nt = tst.n_spheres, tst.n_triangles
    gid[:60] = rng.choice([-1, 0, 1, ns + nt], 60)   # spheres, the plane
    # rays aimed at their primitive: a triangle's centroid, a sphere's
    # centre, a point of the plane
    verts = npy(tds.tri_v0)[:, None] + np.stack(
        [np.zeros_like(npy(tds.tri_e1)), npy(tds.tri_e1), npy(tds.tri_e2)], 1)
    aim = rng.uniform(-2, 2, (301, 3)) * [1, 0, 1] + [0, -4, 0]
    is_s, is_t = gid < ns, (gid >= ns) & (gid < ns + nt)
    aim[is_s] = npy(tds.sph_center)[np.clip(gid[is_s], 0, ns - 1)]
    aim[is_t] = verts[gid[is_t] - ns].mean(1)
    o = rng.uniform(-5, 5, (301, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    jt, jh, jn = JS.intersect_prim_sharded(jds, jst, js, jv(o), jv(d),
                                           jnp.asarray(gid, jnp.int32))
    tix = make_intersector(tds, tst, RenderConfig(accel="none"), shards=ts)
    tt, th, tn = tix.retest(tv(o), tv(d), torch.from_numpy(gid))
    ut, uh, un = TG.intersect_prim_soa(tds, tv(o), tv(d),
                                       torch.from_numpy(gid))
    hm = npy(th)
    assert hm[is_t].sum() > 50 and hm[~is_t].sum() > 20
    np.testing.assert_array_equal(hm, npy(jh))
    np.testing.assert_array_equal(hm, npy(uh))
    np.testing.assert_array_equal(npy(tt)[hm], npy(ut)[hm])
    v3_equal(tn.map(lambda a: a[torch.from_numpy(hm)]),
             un.map(lambda a: a[torch.from_numpy(hm)]))
    np.testing.assert_allclose(npy(tt)[hm], npy(jt)[hm], rtol=1e-6, atol=0)
    v3_close(tn.map(lambda a: a[torch.from_numpy(hm)]),
             jn.map(lambda a: np.asarray(a)[hm]))


@pytest.mark.parametrize("transparent", [True, False])
def test_cluster_folds_match_jax(transparent):
    """The intersector's per-shard cluster sweeps (4 stacked shards) and
    their folds: closest hit and the per-ray shadow sweep, against JAX's
    and against the port's unsharded sweep (exhaustive budgets)."""
    jds, jst, tds, tst = scenes(transparent)
    kw = dict(accel="cluster", bvh_cluster=16, bvh_visits=64,
              bvh_shadow_visits=64)
    jix = jax_make_intersector(jds, jst, JaxConfig(**kw),
                               shards=JS.shard_triangles(jds, jst, 4,
                                                         tri_chunk=512))
    tix = make_intersector(tds, tst, RenderConfig(**kw),
                           shards=TS.shard_triangles(tds, tst, 4,
                                                     tri_chunk=512))
    uix = make_intersector(tds, tst, RenderConfig(**kw))
    assert len(tix.clusters) == 4
    o, d = rays(1, 513)
    jt, jg, jm, jn = jix.closest(jv(o), jv(d))
    tt, tg, tm, tn, tsp = tix.closest(tv(o), tv(d), with_spill=True)
    ut, ug, um, un, usp = uix.closest(tv(o), tv(d), with_spill=True)
    assert int(tsp.max()) == int(usp.max()) == 0
    np.testing.assert_array_equal(npy(tg), npy(jg))
    np.testing.assert_array_equal(npy(tm), npy(jm))
    for a, b in ((tt, ut), (tg, ug), (tm, um)):
        np.testing.assert_array_equal(npy(a), npy(b))
    v3_equal(tn, un)
    np.testing.assert_array_equal(npy(tt), npy(jt))
    v3_equal(tn, jn)

    md = np.full(513, 5.0, np.float32)
    ex = np.full(513, -1)
    jb, jtint = jix.any_tint(jv(o), jv(d), jnp.asarray(md),
                             jnp.asarray(ex, jnp.int32))
    tb, tc, tsp = tix.any_counts(tv(o), tv(d), torch.from_numpy(md),
                                 torch.from_numpy(ex), with_spill=True)
    ub, uc, usp = uix.any_counts(tv(o), tv(d), torch.from_numpy(md),
                                 torch.from_numpy(ex), with_spill=True)
    assert npy(tb).any()
    np.testing.assert_array_equal(npy(tb), npy(jb))
    np.testing.assert_array_equal(npy(tb), npy(ub))
    np.testing.assert_array_equal(npy(tsp), npy(usp))
    if not transparent:
        return
    np.testing.assert_array_equal(npy(tc), npy(uc))
    tint = tix.tint(tc)
    for c in "xyz":
        np.testing.assert_allclose(npy(getattr(tint, c)),
                                   npy(getattr(jtint, c)), rtol=0, atol=1e-6)


def test_tie_in_t_across_shards_goes_to_the_lowest_gid():
    """Triangle 0 twice, once in each of two shards: every ray that hits
    it meets both at the same t, and the fold keeps the lower id, as the
    unsharded fold's strictly-smaller rule and JAX's fold do."""
    kw = lit_kwargs(nt=64)
    tv_ = np.asarray(kw["tri_vertices"])
    tv_[40] = tv_[3]                  # shard 1 (m = 32) repeats triangle 3
    kw["tri_vertices"] = tv_
    jsc, tsc = jax_make_scene(**kw), make_scene(**kw)
    jds = JG.device_scene(jsc.params, jsc.static)
    tds = TG.device_scene(params_to_torch(tsc.params, "cpu"), tsc.static)
    js = JS.shard_triangles(jds, jsc.static, 2, tri_chunk=64)
    ts = TS.shard_triangles(tds, tsc.static, 2, tri_chunk=64)
    assert ts.m == 32
    ns = tsc.static.n_spheres
    # rays from the camera side at the centroid of triangle 3
    cen = tv_[3].mean(0)
    rng = np.random.default_rng(5)
    o = (cen + np.array([0, 0, -6]) + rng.uniform(-0.01, 0.01, (40, 3))
         ).astype(np.float32)
    d = (cen - o) / np.linalg.norm(cen - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    tt, tg, _, _ = TS.closest_hit_sharded(tds, tsc.static, ts, tv(o), tv(d))
    jt, jg, _, _ = JS.closest_hit_sharded(jds, jsc.static, js, jv(o), jv(d))
    ut, ug, _, _ = TG.closest_hit_soa(tds, tsc.static, tv(o), tv(d))
    hit3 = npy(tg) == ns + 3
    assert hit3.sum() > 20
    assert not (npy(tg) == ns + 40).any()
    np.testing.assert_array_equal(npy(tg), npy(jg))
    np.testing.assert_array_equal(npy(tg), npy(ug))
    np.testing.assert_array_equal(npy(tt), npy(ut))
    # the duplicate is really hit at the same t by its own shard
    t1, g1 = TS._shard_closest(ts, 1, tv(o), tv(d)).unbind(1)
    assert (g1[torch.from_numpy(hit3)] == ns + 40).all()
    np.testing.assert_array_equal(npy(t1)[hit3], npy(tt)[hit3])

"""The two-level super-cluster visit order (``bvh_super_group``) of the port
against the JAX package's.

Level 1 is kernel 3 on the super boxes (its plain version here, on the
CPU); level 2 is plain torch.  Against ``traverse._visit_order_super`` on
seeded NumPy boxes, at S > 32 (the JAX package's ``lax.top_k`` branch,
whose lists hold distinct supers): ids and entries of the listed slots,
the ok mask and the spill, bit for bit, with ``count_max_dist``, with a
budget above S·G, and with rays whose origins lie inside boxes (entry-0
ties).  Two faults of the JAX order are not copied, and each has a test
that shows both behaviours:

* at S <= 32 (``_k_smallest``) a ray that enters fewer than S supers gets
  super 0 again in every later slot, so super 0's members fill visit
  slots twice; the port's list is the JAX list with the repeats removed;
* the padding of a short last super (lo = +FLT_MAX, hi = -FLT_MAX) passes
  the slab test of every ray at entry 0, so the padding's ids (>= K) take
  the first slots of every ray that lists that super; the port lists no
  padding, and with a padded last super the JAX lists are compared
  without those ids.

Frames: the 2,000-triangle lit soup of tests/test_parallel.py (fov 55°,
see tests/test_torch_mesh_render.py) at G = 2 (K = 125 clusters, 63
supers, the last one padded) and S = 48, against the JAX package's
frame of the same config (op by op, its uniforms injected): the opaque
soup's closest hits with shared shadows, and the transparent soup's
per-ray shadows.  And the port against its own dense order: S covering
every super renders the dense frame, and a starved S reports its spill.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.accel import traverse as JT
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.accel import traverse as TT
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import make_scene
from test_torch_union_render import STACK_STATS, compare_frames

pytest_plugins = ("torch_harness",)

FLT_MAX = float(np.finfo(np.float32).max)


def boxes(K, seed, big=4):
    """K boxes in [-4, 4]^3 of sides 0.2-2, the first ``big`` of them
    holding the whole cube (every origin inside them: entry-0 ties)."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-4, 4, (K, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 2, (K, 3)).astype(np.float32)
    lo[:big], hi[:big] = -5, 5
    return lo, hi


def rays(R, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8, 1:] = 0           # axis-aligned rays: the slab test's 1e-30 nudge
    d[:8, 0] = 1
    return o, d


def cluster_sets(lo, hi):
    """(JAX ClusterSet, port ClusterSet) holding only the boxes: the visit
    orders read nothing else."""
    K = lo.shape[0]
    j = JT.ClusterSet(blk=jnp.zeros((K, 13, 1)), lo=jnp.asarray(lo),
                      hi=jnp.asarray(hi), gid0=jnp.int32(0), flat=None,
                      bound=None)
    t = TT.ClusterSet(blk=torch.zeros((K, 13, 1)), lo=torch.from_numpy(lo),
                      hi=torch.from_numpy(hi), gid0=0, flat=None, bound=None)
    return j, t


def both_orders(K, G, S, visits, cmd, seed, R=256):
    """The JAX and the port's ``_visit_order_super`` on the same boxes and
    rays, as NumPy (cids, ok, entry, spill)."""
    lo, hi = boxes(K, seed)
    o, d = rays(R, seed + 1)
    md = (np.random.default_rng(seed + 2).uniform(0.5, 6, R)
          .astype(np.float32) if cmd else None)
    jcs, tcs = cluster_sets(lo, hi)
    with jax.disable_jit():
        j = JT._visit_order_super(
            jcs, jnp.asarray(o), jnp.asarray(d), visits, G, S,
            None if md is None else jnp.asarray(md))
    t = TT._visit_order_super(
        tcs, torch.from_numpy(o), torch.from_numpy(d), visits, G, S,
        None if md is None else torch.from_numpy(md))
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def drop_ids(cids, ok, entry, K, G, S, visits):
    """A JAX row's listed (id, entry) pairs without ids >= K (padding)
    and without repeats of an id, in list order."""
    seen, out = set(), []
    for c, k, e in zip(cids, ok, entry):
        if k and c < K and c not in seen:
            seen.add(c)
            out.append((int(c), float(e)))
    return out


@pytest.mark.parametrize("case", [
    # K, G, S, visits, count_max_dist
    (200, 5, 36, 64, False),        # 40 supers, no padding
    (200, 5, 36, 64, True),
    (200, 5, 36, 400, False),       # visits above S·G = 180 and K
    (160, 4, 40, 8, True),          # every super kept, a short budget
])
def test_visit_order_super_matches_jax(case):
    K, G, S, visits, cmd = case
    (jc, jok, je, jsp), (tc, tok, te, tsp) = both_orders(K, G, S, visits,
                                                         cmd, seed=K + S)
    assert tc.shape == jc.shape == (256, min(visits, K, S * G))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tc[tok], jc[jok])
    np.testing.assert_array_equal(te[tok], je[jok])
    np.testing.assert_array_equal(tsp, jsp)
    assert (tc[~tok] == 0).all() and (te[~tok] == FLT_MAX).all()
    # entry-0 ties among the listed clusters, and some truncation
    assert ((te == 0).sum(1) >= 2).any()
    if visits < K:
        assert tsp.max() > 0


@pytest.mark.parametrize("cmd", [False, True])
def test_padded_last_super_matches_jax_without_padding(cmd):
    """K = 203 at G = 5: 41 supers, the last with two padding members.
    The port's lists are the JAX lists without the padding's ids, and its
    spill counts no padding."""
    K, G, S, visits = 203, 5, 41, 203
    (jc, jok, je, jsp), (tc, tok, te, tsp) = both_orders(K, G, S, visits,
                                                         cmd, seed=5)
    padded_rows = (jok & (jc >= K)).any(1)
    assert padded_rows.all()        # S = Ks: every ray lists the last super
    assert (tc[tok] < K).all()
    for r in range(tc.shape[0]):
        want = drop_ids(jc[r], jok[r], je[r], K, G, S, visits)
        got = [(int(c), float(e)) for c, e in zip(tc[r][tok[r]],
                                                  te[r][tok[r]])]
        assert got == want, r
    n_pad = (jok & (jc >= K)).sum(1)
    if not cmd:     # the padding sits at entry 0, inside every max_dist
        np.testing.assert_array_equal(
            np.maximum(tok.sum(1) + n_pad - visits, 0), jsp)
    assert (tsp == 0).all()


@pytest.mark.parametrize("S", [8, 16])
def test_small_s_lists_are_jax_lists_without_repeats(S):
    """S <= 32: the JAX lists repeat super 0's members after the last
    entered super; the port's list starts with the JAX list's distinct
    ids, in its order, and counts no repeat in its spill."""
    K, G, visits = 200, 5, 48
    (jc, jok, je, jsp), (tc, tok, te, tsp) = both_orders(K, G, S, visits,
                                                         True, seed=S)
    repeats = 0
    for r in range(tc.shape[0]):
        want = drop_ids(jc[r], jok[r], je[r], K, G, S, visits)
        got = [(int(c), float(e)) for c, e in zip(tc[r][tok[r]],
                                                  te[r][tok[r]])]
        assert got[:len(want)] == want, r
        assert len(set(c for c, _ in got)) == len(got)
        repeats += int(jok[r].sum()) - len(want)
    assert repeats > 0
    assert (tsp <= jsp).all()


def test_repeated_super_zero_on_one_ray():
    """16 unit boxes, G = 4, S = 4, 16 visits, a ray that enters boxes
    0-7 (supers 0 and 1) only: the JAX list holds super 0's members three
    times; the port's holds boxes 0-7 once."""
    K = 16
    lo = np.zeros((K, 3), np.float32)
    lo[:8, 0] = 2 * np.arange(8)
    lo[8:, 0] = 2 * np.arange(8)
    lo[8:, 1] = 10
    hi = lo + 1
    o = np.array([[-1, 0.5, 0.5]], np.float32)
    d = np.array([[1, 0, 0]], np.float32)
    jcs, tcs = cluster_sets(lo, hi)
    with jax.disable_jit():
        jc, jok, _, _ = JT._visit_order_super(jcs, jnp.asarray(o),
                                              jnp.asarray(d), 16, 4, 4)
    tc, tok, te, tsp = TT._visit_order_super(tcs, torch.from_numpy(o),
                                             torch.from_numpy(d), 16, 4, 4)
    assert np.asarray(jc)[0].tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3,
                                          3, 4, 5, 6, 7]
    assert bool(np.asarray(jok).all())
    assert tc[0][tok[0]].tolist() == list(range(8))
    assert te[0][tok[0]].tolist() == [1.0 + 2 * i for i in range(8)]
    assert int(tok.sum()) == 8 and int(tsp[0]) == 0


# -- frames -----------------------------------------------------------------

def lit_soup_kwargs(nt=2000, transparent=True):
    """make_scene arguments of tests/test_parallel.py's ``_lit_soup``, at
    fov 55°."""
    rng = np.random.default_rng(0)
    tv = rng.uniform(-3, 3, (nt, 3, 3)).astype(np.float32)
    tv[:, 1:] = tv[:, :1] + rng.uniform(-0.4, 0.4, (nt, 2, 3)).astype(
        np.float32)
    tri_mat = dict(ks=[1, 1, 1], ka=[.2, .2, .2], tex_color=[1, 1, 1])
    if transparent:
        tri_mat["kt"] = [.5, .6, .7]
    return dict(
        sphere_center=[[0.0, 0.0, 0.0], [0.0, 6.0, -2.0]],
        sphere_radius=[0.5, 1.0],
        sphere_material=[0, 2], sphere_lights=[0, 4],
        tri_vertices=tv, tri_material=[1] * nt,
        plane_point=[[0, -4, 0]], plane_normal=[[0, 1, 0]],
        plane_material=[0],
        materials=[
            dict(ks=[1, 1, 1], ka=[.1, .1, .1], tex_color=[1, 1, 1]),
            tri_mat,
            dict(ke=[4, 4, 4], tex_color=[1, 1, 1]),
        ],
        camera=dict(position=[0, 0, -8], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=55, focal_length=1),
        ambient=(0.3, 0.3, 0.3))


@functools.lru_cache(maxsize=None)
def lit_soup(transparent):
    """(JAX scene, port scene) of the lit soup, both Morton-ordered."""
    kw = lit_soup_kwargs(transparent=transparent)
    return jax_reorder(jax_make_scene(**kw)), reorder_scene(make_scene(**kw))


SUPER = dict(bvh_super_group=2, bvh_super_sel=48)   # K = 125, Ks = 63


@pytest.mark.parametrize("case", ["closest_opaque", "per_ray_transparent"])
def test_super_frames_match_jax(case):
    transparent = case == "per_ray_transparent"
    jsc, sc = lit_soup(transparent)
    kw = dict(max_bounces=1, light_chunk=4, accel="cluster", **SUPER)
    if transparent:
        kw.update(shadow_mode="per_ray", bvh_visits=32,
                  bvh_shadow_visits=32)
    st = compare_frames(jsc, sc, kw, (16, 16), 7, stats=STACK_STATS,
                        share=0.99 if transparent else 1.0)
    assert float(st["shadow_rays"]) > 0
    if transparent:
        assert float(st["children_pushed"]) > 0


def port_frame(sc, **kw):
    fn = make_renderer(sc.static, RenderConfig(
        max_bounces=2, rounds=3, accel="cluster", light_chunk=4,
        bvh_visits=128, **kw), 16, 16, device="cpu", with_stats=True)
    img, _, st = fn(sc.params, PhiloxSampler(1, "cpu"))
    return img, {k: float(v) for k, v in st.items()}


def test_super_covering_every_super_is_the_dense_frame():
    """tests/test_accel.py's parity and guard check, the port against its
    own dense order: G = 16, S = Ks renders the dense frame bit for bit
    with the same spill; S = 1 reports a larger one."""
    _, sc = lit_soup(False)
    K = -(-2000 // 16)
    Ks = -(-K // 16)
    img_d, st_d = port_frame(sc, bvh_super_group=0)
    img_s, st_s = port_frame(sc, bvh_super_group=16, bvh_super_sel=Ks)
    assert torch.equal(img_s, img_d)
    assert st_s == st_d
    _, st_b = port_frame(sc, bvh_super_group=16, bvh_super_sel=1)
    assert st_b["visit_spill_max"] > st_d["visit_spill_max"]

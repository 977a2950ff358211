"""The spill diagnostics and the spill policy (c_raytracer_tpu_torch/
accel/traverse.py ``spill_counts``, ``shadow_spill_counts``;
accel/validate.py ``spill_report``, ``tuned_config``) against the JAX
package's, and kernel 3's passes above 256 slots modelled in numpy.

* The counts on the same cluster boxes, rays and hit points as JAX's
  (run op by op): the closest-hit overlap and spill equal; the shadow
  cluster and triangle spills equal except where the capsule dot's
  summation order (JAX's ``einsum`` against the port's products) flips a
  pixel on the boundary, at most 0.1% of the pixels; the pixel-chunked
  path equal to the unchunked one.
* ``spill_report``'s dict and ``tuned_config``'s config equal to JAX's
  (its probe under ``jax.disable_jit``: jitted, fused hit points are ulps
  off) on a transparent soup with starved budgets (union mode) and on
  scenes/meshes_opaque.json at 16x12 (shared mode with the shortlist).
* Kernel 3 above 256: passes of 256 slots, each admitting only boxes
  after the previous pass's last slot in (key, id) order
  (``pallas_visit.visit_passes``), modelled with the split-and-merge model
  of tests/test_torch_visit_split.py: equal to the stable sort of
  ``visit_order_reference``, ties and ``count_max_dist`` included.
"""

import dataclasses
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.accel import traverse as jax_traverse
from c_raytracer_tpu.accel.validate import tuned_config as jax_tuned
from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.scene import load_scene as jax_load_scene
from c_raytracer_tpu_torch.accel import make_intersector, reorder_scene
from c_raytracer_tpu_torch.accel import pallas_visit as PV
from c_raytracer_tpu_torch.accel import traverse
from c_raytracer_tpu_torch.accel.validate import spill_report, tuned_config
from c_raytracer_tpu_torch.geometry import device_scene
from c_raytracer_tpu_torch.render import RenderConfig
from c_raytracer_tpu_torch.scene import load_scene, params_to_torch
from test_torch_union_render import glass_soup
from test_torch_visit_split import (FLT_MAX, boxes,
                                    duplicate_at_boundaries, kernel_model,
                                    rays, slab)

MESH = os.path.join(os.path.dirname(__file__), "..", "scenes",
                    "meshes_opaque.json")
# the soup's budgets starved so that every count spills: 4 closest-hit
# visits, 4 shadow visits over the 16-triangle clusters
SOUP_KW = dict(bvh_visits=4, bvh_shadow_visits=4, bvh_shadow_cluster=16)


@functools.lru_cache(maxsize=None)
def _mesh():
    return (jax_reorder(jax_load_scene(MESH)),
            reorder_scene(load_scene(MESH)))


def _clusters(scene):
    p = params_to_torch(scene.params, "cpu")
    return make_intersector(device_scene(p, scene.static), scene.static,
                            RenderConfig()).clusters


def _jax_cs(cs):
    """The port's cluster boxes and bounding spheres as JAX arrays."""
    return SimpleNamespace(lo=jnp.asarray(cs.lo.numpy()),
                           hi=jnp.asarray(cs.hi.numpy()),
                           bound=jnp.asarray(cs.bound.numpy()))


def _probe_rays(cs, n, seed):
    """Rays from random origins in the boxes' span, aimed at random box
    centres, and random hit points on those rays."""
    rng = np.random.default_rng(seed)
    lo, hi = cs.lo.numpy(), cs.hi.numpy()
    span_lo, span_hi = lo.min(0), hi.max(0)
    o = rng.uniform(span_lo - 2, span_hi + 2, (n, 3)).astype(np.float32)
    c = 0.5 * (lo + hi)[rng.integers(0, lo.shape[0], n)]
    d = (c - o) / np.linalg.norm(c - o, axis=1, keepdims=True)
    hp = (o + d * rng.uniform(0.5, 3.0, (n, 1))).astype(np.float32)
    return o, d.astype(np.float32), hp


@pytest.mark.parametrize("scene", ["soup", "mesh"])
def test_spill_counts_equal_jax(scene):
    cs = _clusters(glass_soup()[1] if scene == "soup" else _mesh()[1])
    o, d, _ = _probe_rays(cs, 512, 1)
    n, spill = traverse.spill_counts(cs, torch.from_numpy(o),
                                     torch.from_numpy(d), 8)
    with jax.disable_jit():
        jn, js = jax_traverse.spill_counts(_jax_cs(cs), jnp.asarray(o),
                                           jnp.asarray(d), 8)
    assert n.dtype == spill.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(spill.numpy(), np.asarray(js))
    assert spill.max() > 0


def _shadow(cs, hp, k_short, emitter):
    lo, hi = emitter
    return traverse.shadow_spill_counts(
        cs, torch.from_numpy(hp), torch.tensor(lo), torch.tensor(hi), 8,
        k_short)


@pytest.mark.parametrize("scene", ["soup", "mesh"])
def test_shadow_spill_counts_equal_jax(scene):
    cs = _clusters(glass_soup()[1] if scene == "soup" else _mesh()[1])
    _, _, hp = _probe_rays(cs, 4096 if scene == "soup" else 1024, 2)
    emitter = ([-0.5, 5.5, -3.5], [0.5, 6.5, -2.5])
    cl, tri = _shadow(cs, hp, 32, emitter)
    with jax.disable_jit():
        jcl, jtri = jax_traverse.shadow_spill_counts(
            _jax_cs(cs), jnp.asarray(hp), jnp.asarray(emitter[0]),
            jnp.asarray(emitter[1]), 8, 32)
    # boundary pixels the einsum's summation order may flip: <= 0.1%
    for ours, theirs in ((cl, jcl), (tri, jtri)):
        flips = (ours.numpy() != np.asarray(theirs)).sum()
        assert flips <= 1e-3 * hp.shape[0]
        assert ours.max() > 0
    # without the shortlist: no triangle count
    cl0, tri0 = _shadow(cs, hp, 0, emitter)
    assert torch.equal(cl0, cl) and not tri0.any()


def test_chunked_counts_equal_unchunked(monkeypatch):
    """Per-pixel counts do not depend on the pixel chunks."""
    cs = _clusters(glass_soup()[1])
    o, d, hp = _probe_rays(cs, 300, 3)
    emitter = ([-0.5, 5.5, -3.5], [0.5, 6.5, -2.5])
    whole = (traverse.spill_counts(cs, torch.from_numpy(o),
                                   torch.from_numpy(d), 8)
             + _shadow(cs, hp, 32, emitter))
    monkeypatch.setattr(traverse, "_CHUNK_ELEMS", 7 * cs.bound.shape[0]
                        * cs.bound.shape[1] + 5)
    assert len(traverse._row_chunks(300, cs.lo.shape[0])) > 1
    assert len(traverse._row_chunks(
        300, cs.bound.shape[0] * cs.bound.shape[1])) == 43
    chunked = (traverse.spill_counts(cs, torch.from_numpy(o),
                                     torch.from_numpy(d), 8)
               + _shadow(cs, hp, 32, emitter))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scene", ["soup_union", "mesh_shared"])
def test_report_and_tuned_config_equal_jax(scene):
    if scene == "soup_union":
        jsc, sc = glass_soup()
        kw, res = SOUP_KW, (16, 16)
    else:
        jsc, sc = _mesh()
        kw, res = {}, (16, 12)
    with jax.disable_jit():
        jcfg, jrep = jax_tuned(jsc, JaxConfig(**kw), *res)
    cfg, rep = tuned_config(sc, RenderConfig(**kw), *res, device="cpu")
    assert rep["closest"] == jrep["closest"]
    assert rep == jrep
    assert rep["closest"]["spill_max"] > 0
    assert rep["shadow"][0]["cluster_spill_max"] > 0
    assert rep["shadow_mode"] == ("union" if scene == "soup_union"
                                  else "shared")
    shared = {f.name for f in dataclasses.fields(JaxConfig)} & {
        f.name for f in dataclasses.fields(RenderConfig)}
    assert {k: getattr(cfg, k) for k in shared} == {
        k: getattr(jcfg, k) for k in shared}
    assert cfg.bvh_visits > RenderConfig(**kw).resolved_visits(
        scene == "soup_union")
    # the tuned budgets cover the measured overlap: no spill left
    assert spill_report(sc, cfg, *res, device="cpu")["closest"][
        "spill_max"] == 0


def test_report_without_clusters():
    _, sc = glass_soup()
    rep = spill_report(sc, RenderConfig(accel="none"), 8, 8, device="cpu")
    assert rep == {"accel": "none", "closest": None, "shadow": []}
    cfg = RenderConfig(accel="none")
    assert tuned_config(sc, cfg, 8, 8, device="cpu") == (cfg, rep)


def passes_model(o, d, lo, hi, V, cmd, n_sm):
    """Kernel 3's output for a V of several passes: each pass the split
    and merge of ``kernel_model`` over the boxes after the previous pass's
    last slot, its spill counted against the whole V."""
    R = o.shape[0]
    cids = np.zeros((R, V), np.int32)
    ent = np.full((R, V), FLT_MAX, np.float32)
    after = None
    for col0, v in PV.visit_passes(V):
        c, e, spill = kernel_model(o, d, lo, hi, v, cmd, n_sm, after=after,
                                   spill_v=V)
        cids[:, col0:col0 + v], ent[:, col0:col0 + v] = c, e
        after = [(float(e[r, -1]), int(c[r, -1])) for r in range(R)]
    return cids, ent, spill


@pytest.mark.parametrize("V,variant", [
    (300, "plain"), (512, "plain"), (384, "count_max_dist"), (520, "ties"),
    (1200, "plain")])
def test_passes_model_equals_reference(V, variant):
    lo, hi = boxes(6, 1200, half=(2.0, 3.5))
    o, d = rays(7, 48, lo, hi)
    cmd = None
    if variant == "ties":
        lo, hi = duplicate_at_boundaries(lo, hi, 48, PV.PASS_V, 2)
        # copies of box 5 around the first pass's last slot of most rays
        lo[250:262], hi[250:262] = lo[5], hi[5]
    if variant == "count_max_dist":
        cmd = np.random.default_rng(8).uniform(2, 8, 48).astype(np.float32)
    mc, me, ms = passes_model(o, d, lo, hi, V, cmd, 2)
    t = torch.from_numpy
    pc, pe, ps = PV.visit_order_reference(
        t(o), t(d), t(lo), t(hi), V, None if cmd is None else t(cmd))
    pc, pe, ps = pc.numpy(), pe.numpy(), ps.numpy()
    ok = pe < FLT_MAX
    np.testing.assert_array_equal(me < FLT_MAX, ok)
    np.testing.assert_array_equal(ms, ps)
    np.testing.assert_array_equal(mc[ok], pc[ok])
    np.testing.assert_array_equal(me[ok], pe[ok])
    # the second pass holds entries; V below the overlaps spills
    assert ok[:, PV.PASS_V:].any()
    _, overlap, _ = slab(o, d, lo, hi)
    if V < overlap.sum(1).max():
        assert ps.max() > 0
    # the CPU wrapper takes any V <= K
    wc, we, ws = PV.visit_order(t(o), t(d), t(lo), t(hi), V,
                                None if cmd is None else t(cmd))
    assert torch.equal(ws, t(ps)) and torch.equal(we, t(pe))


def test_visit_passes():
    assert PV.visit_passes(16) == [(0, 16)]
    assert PV.visit_passes(256) == [(0, 256)]
    assert PV.visit_passes(257) == [(0, 256), (256, 1)]
    assert PV.visit_passes(1024) == [(0, 256), (256, 256), (512, 256),
                                     (768, 256)]
    split = PV.visit_split(2048, 6300, 384)
    assert (split.vm, split.warps, split.passes) == (256, 2, 2)

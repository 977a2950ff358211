"""Acceleration spill policy: measure truncation, prove exhaustiveness,
auto-raise the budgets, as in ``c_raytracer_tpu.accel.validate``.

The cluster sweep (traverse.py) bounds per-ray work with two budgets: the
nearest-``visits`` clusters per query and (for opaque soft shadows) a
``shortlist`` of candidate triangles per pixel.  Both truncate the
reference's exhaustive BVH walk (accel.c:322-387):

* **closest hit**: nearest-first visits with best-t pruning; a spilled
  cluster can only steal the hit if it is nearer than the best found.
  Rays inside a transparent mesh see many zero-entry clusters and need a
  larger V.
* **shadows, opaque scene**: any-hit, so a dropped far blocker matters
  only when no nearer one hits; the shortlist of 32 is the default.
* **shadows, transparent scene**: the kt tint is a product over ALL
  blockers along the segment, so any truncation leaks light.
* **proof**: ``spill == 0`` proves a sweep exhaustive.  ``spill_report``
  measures it for a scene and config on the camera's own rays;
  ``tuned_config`` raises the budgets until the measured spill is zero
  (capped at the cluster count).  The renderer's always-on guard
  (``shadow_spill_max``, ``visit_spill_max``) covers every frame; the
  CLI warns when either is nonzero.

The closest-hit probe runs ``Intersector.closest`` in the renderer's
cluster tiles of 2,048 rays; every ray's hit is independent of the tiling.
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.accel import traverse
from c_raytracer_tpu_torch.accel.intersect import make_intersector
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.geometry import primitives as G
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.scene.convert import params_to_torch

PROBE_TILE = 2048  # rays a closest-hit probe call: the auto cluster tile


def _ceil8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


@torch.no_grad()
def spill_report(scene, cfg, resx: int, resy: int, *, device) -> dict:
    """Measure visit/shortlist spill on the scene's own camera rays, on
    ``device``.

    Returns a dict: ``closest`` (primary-ray cluster overlap vs
    bvh_visits) and ``shadow`` (per-emitter capsule overlap at primary hit
    points vs the resolved shadow budgets).  All counts are exact — the
    probe runs the same slab/capsule tests as the sweeps, with no
    truncation."""
    static = scene.static
    params = params_to_torch(scene.params, device)
    ix = make_intersector(G.device_scene(params, static), static, cfg)
    if ix.clusters is None:
        return {"accel": "none", "closest": None, "shadow": []}
    cs = ix.clusters
    K = cs.lo.shape[0]
    any_transp = any(static.is_transparent)

    o_a, d_a = primary_rays(params.camera, resx, resy)
    o_a, d_a = o_a.contiguous(), d_a.contiguous()
    n_ov, spill = traverse.spill_counts(
        cs, o_a, d_a, cfg.resolved_visits(any_transp))
    hit, hp_a = [], []
    for i in range(0, o_a.shape[0], PROBE_TILE):
        o = v3m.from_aos(o_a[i:i + PROBE_TILE])
        d = v3m.from_aos(d_a[i:i + PROBE_TILE])
        t, gid, _, _ = ix.closest(o, d)
        h = gid >= 0
        hit.append(h)
        hp_a.append(v3m.to_aos(o + d * torch.where(h, t, 1.0)))
    hit = torch.cat(hit)
    hp_hit = torch.cat(hp_a)[hit].contiguous()

    mode = cfg.resolved_shadow_mode(any_transp)
    if mode == "union":
        # union mode sweeps its own cluster set with the union budget;
        # the capsule count on THAT set is a conservative upper bound on
        # any per-pixel sample union (every sample segment lies inside
        # the capsule), so capsule spill == 0 proves the budget covers
        sv = cfg.resolved_union_visits(any_transp)
        k_short = 0
        cs_sh = ix._shadow_cs
    else:
        sv = cfg.resolved_shadow_visits(any_transp)
        k_short = cfg.resolved_shadow_shortlist(any_transp)
        cs_sh = cs

    shadow = []
    for egid in static.emitter_prims:
        if static.num_lights[egid] == 0:
            continue
        elo, ehi = ix.emitter_bounds(int(egid))
        cl_sp, tri_sp = (x.cpu().numpy() for x in traverse.shadow_spill_counts(
            cs_sh, hp_hit, elo, ehi, sv, k_short))
        shadow.append(dict(
            egid=int(egid),
            visits=sv, shortlist=k_short,
            cluster_spill_max=int(cl_sp.max()) if cl_sp.size else 0,
            cluster_spill_pixels=int((cl_sp > 0).sum()),
            tri_spill_max=int(tri_sp.max()) if tri_sp.size else 0,
            tri_spill_pixels=int((tri_sp > 0).sum()),
        ))

    n_ov = n_ov.cpu().numpy()
    spill = spill.cpu().numpy()
    return {
        "accel": "cluster",
        "shadow_mode": mode,
        "n_clusters": int(K),
        "closest": dict(
            visits=cfg.resolved_visits(any_transp),
            overlap_max=int(n_ov.max()),
            overlap_mean=float(n_ov.mean()),
            spill_max=int(spill.max()),
            spill_rays=int((spill > 0).sum()),
        ),
        "shadow": shadow,
    }


def tuned_config(scene, cfg, resx: int, resy: int, *, device,
                 headroom: float = 2.0, max_visits: int = 1024):
    """Return (config, report): a config whose budgets cover the MEASURED
    overlap counts, and ``spill_report``'s dict.

    ``bvh_visits`` is raised to headroom × the max primary-ray cluster
    overlap (secondary rays inside transparent meshes see more zero-entry
    clusters than primaries, hence the headroom).  Shadow visits are
    raised to the max capsule overlap at the primary hit points — an
    upper bound on true segment blockers, so shadow sweeps become provably
    exhaustive.  Budgets are capped at the cluster count (a budget of K IS
    brute force over clusters) and at ``max_visits``."""
    rep = spill_report(scene, cfg, resx, resy, device=device)
    if rep["closest"] is None:
        return cfg, rep
    K = rep["n_clusters"]
    any_transp = any(scene.static.is_transparent)
    v = min(max_visits, K,
            _ceil8(rep["closest"]["overlap_max"] * headroom))
    v = max(cfg.resolved_visits(any_transp), v)
    sv_needed = max(
        (s["cluster_spill_max"] + s["visits"] for s in rep["shadow"]),
        default=v)
    sv = min(max_visits, K, max(_ceil8(sv_needed), v))
    k_short = 0 if any_transp else cfg.resolved_shadow_shortlist(False)
    tuned = dataclasses.replace(
        cfg, bvh_visits=v, bvh_shadow_visits=sv,
        bvh_shadow_shortlist=k_short)
    return tuned, rep

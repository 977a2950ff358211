"""Wavefront integrator, chain half, as in ``c_raytracer_tpu.render.integrator``:
the reference's recursive cast_ray tree (render.c:136-343) for scenes with
no transparent material, where refraction can never fire and each ray has
at most one child (its mirror reflection), so the pending set is one
carried ray per pixel.

The JAX package's ``lax.scan`` over bounce rounds is a Python loop here,
and its dead-round ``lax.cond`` is ``if not live.any(): break`` — one host
sync per round (a CUDA graph of the round body would remove it).

Not ported yet, and refused with ``NotImplementedError``: the stack
integrator (transparent materials, refraction) and path-traced GI.
"""

from __future__ import annotations

import torch

from c_raytracer_tpu_torch.accel.intersect import make_intersector
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.geometry import primitives as G
from c_raytracer_tpu_torch.render import shading
from c_raytracer_tpu_torch.render.config import GI_AMBIENT, GI_PATH, RenderConfig
from c_raytracer_tpu_torch.scene import types as T

STAT_KEYS = ("main_rays", "shadow_rays", "gi_rays", "children_pushed",
             "dropped", "shadow_spill_max", "visit_spill_max")


def _trace(ix, o: V3, d: V3):
    """Intersection step of the JAX package's ``_trace(..., inside=None)``:
    chain-mode rays never enter objects (the inside-object re-test belongs
    to the stack integrator).  Returns (t, gid, mat, normal V3,
    visit_spill (P,))."""
    return ix.closest(o, d)


def _round_shade(ix, static, cfg, k_shade, ro: V3, rd: V3, rkr: V3,
                 remaining: int, active):
    """Trace + shade + child spawn for one chain round (ambient GI, no
    refraction).  Returns a dict of per-lane results."""
    ds = ix.ds
    t, gid, mat, normal, tr_spill = _trace(ix, ro, rd)
    hit = gid >= 0
    active_hit = active & hit
    visit_spill = torch.where(active, tr_spill, 0).max()

    obj_color, aux = shading.shade_basic(
        ix, static, cfg, k_shade, ro, rd, t, gid, mat, normal, active_hit)

    # ambient GI (render.c:232-236)
    ambient = v3m.rows(ds.materials.ka, mat) * v3m.splat(ds.ambient)
    obj_color = obj_color + v3m.where(active_hit, ambient, 0.0)

    # accumulate: kr ⊙ obj_color, per-segment attenuation (render.c:291-302)
    contrib = shading.attenuate_segment(cfg, rkr * obj_color, t)
    contrib = v3m.where(active_hit, contrib, 0.0)

    # primary z-buffer value: t of first hit; 0 on miss and when -b 0
    z_val = torch.where(hit & (remaining > 0), t, 0.0)

    can_bounce = active_hit & (remaining > 0)
    reflective = ds.mat_reflective[mat]
    refl_kr = rkr * v3m.rows(ds.materials.kr, mat)
    push_refl = (can_bounce & reflective
                 & (v3m.magsqr(refl_kr) > cfg.min_light_intensity_sqr))
    refl_d = shading.reflect_dir(rd, normal, aux["b"])
    return dict(t=t, gid=gid, hit=hit, active_hit=active_hit,
                contrib=contrib, z_val=z_val, hit_pt=aux["hit_pt"],
                push_refl=push_refl, refl_d=refl_d, refl_kr=refl_kr,
                visit_spill=visit_spill)


def _stat_weights(static: T.SceneStatic, cfg: RenderConfig):
    """Per-hit shadow rays (emitters × sample counts, render.c:170-176)
    and GI rays per primary/secondary hit."""
    shadow_rays_per_hit = float(sum(
        static.num_lights[e] for e in static.emitter_prims))
    gi_per_secondary = 1.0 if cfg.gi_model == GI_PATH else 0.0
    gi_per_primary = (float(cfg.samples_per_pixel)
                      if cfg.gi_model == GI_PATH else 0.0)
    return shadow_rays_per_hit, gi_per_primary, gi_per_secondary


def _render_chain(ds: G.DeviceScene, static: T.SceneStatic,
                  cfg: RenderConfig, key, o: V3, d: V3, *, with_stats: bool):
    P, dev = o.x.shape, o.x.device
    ix = make_intersector(ds, static, cfg)
    rounds = min(cfg.rounds or (cfg.max_bounces + 1), cfg.max_bounces + 1)
    sh_w, gi_p, gi_s = _stat_weights(static, cfg)

    color = v3m.full(P, 0.0, device=dev)
    z = torch.zeros(P, dtype=torch.float32, device=dev)
    ro, rd, rkr = o, d, v3m.full(P, 1.0, device=dev)
    live = torch.ones(P, dtype=torch.bool, device=dev)
    # counts in float64: exact for any frame size (the JAX package's f32
    # counters round above 2^24)
    stats = torch.zeros(len(STAT_KEYS), dtype=torch.float64, device=dev)

    for round_i in range(rounds):
        if not bool(live.any()):
            break  # every chain has died: the remaining rounds do no work
        remaining = cfg.max_bounces - round_i  # same depth on every lane
        is_primary = remaining == cfg.max_bounces
        r = _round_shade(ix, static, cfg, key.fold_in(round_i), ro, rd, rkr,
                         remaining, live)
        color = color + r["contrib"]
        if is_primary:
            z = torch.where(live, r["z_val"], z)

        live2 = r["push_refl"]
        n_hit = r["active_hit"].sum(dtype=torch.float64)
        stats[0] += live.sum(dtype=torch.float64)
        stats[1] += n_hit * sh_w
        stats[2] += n_hit * (gi_p if is_primary else gi_s)
        stats[3] += live2.sum(dtype=torch.float64)
        # stats[4] (stack drops) and stats[5] (shadow spill) stay 0: the
        # chain has no stack and the dense shadow sweep is exhaustive
        stats[6] = torch.maximum(stats[6], r["visit_spill"].to(torch.float64))
        ro, rd, rkr, live = r["hit_pt"], r["refl_d"], r["refl_kr"], live2
    return _finish(color, z, stats, with_stats)


def _finish(color: V3, z, stats, with_stats):
    color = v3m.to_aos(color)
    if with_stats:
        return color, z, dict(zip(STAT_KEYS, stats.unbind()))
    return color, z


def render_wavefront(ds: G.DeviceScene, static: T.SceneStatic,
                     cfg: RenderConfig, key, o, d, *, with_stats=False):
    """Render one tile of primary rays.

    o, d: (P, 3) primary origins/directions; ``key`` a ``rng.SampleKey``
    naming the tile.  Returns (color (P, 3), zbuffer (P,)) and, with
    ``with_stats``, a dict of ray counts (0-d float64 tensors) under the
    JAX package's keys."""
    if any(static.is_transparent):
        raise NotImplementedError(
            "transparent materials need the stack integrator, which is not "
            "ported yet (ROADMAP: the stack integrator)")
    if cfg.gi_model != GI_AMBIENT:
        raise NotImplementedError(
            f"gi_model={cfg.gi_model!r} is not ported yet (ROADMAP: path GI)")
    return _render_chain(ds, static, cfg, key, v3m.from_aos(o),
                         v3m.from_aos(d), with_stats=with_stats)

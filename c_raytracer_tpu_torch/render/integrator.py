"""Wavefront integrator, as in ``c_raytracer_tpu.render.integrator``: the
reference's recursive cast_ray tree (render.c:136-343) in rounds.

* chain (no transparent material): refraction can never fire and each ray
  has at most one child (its mirror reflection), so the pending set is one
  carried ray per pixel;
* stack (any transparent material): a per-pixel LIFO of pending rays
  (``RayStack``, S slots) holds the reflect + refract tree; each round pops
  one ray per pixel, traces it with the inside-object re-test, shades it
  and pushes its refraction child, then its reflection child.  A push onto
  a full stack is dropped and counted.  Pop and push are one-hot selects
  and sums over the small S axis, as in the JAX package: no indexed gather
  or scatter, whose CUDA backward would sort.

The JAX package's ``lax.scan`` over rounds is a Python loop here, and its
dead-round ``lax.cond`` is a ``break`` once no pixel has a ray: one host
sync per round (a CUDA graph of the round body would remove it).

The intersector (and the cluster packs of a mesh scene) depends only on
the scene parameters, so ``make_renderer`` builds it once per frame and
hands it to every tile.

Path-traced GI (``gi_model="path"``, render.c:238-287) shades each hit's
hemisphere samples inline: a one-bounce trace and a basic shade a sample,
``samples_per_pixel`` of them at primary hits and one at secondary hits.
Its draws are keyed by their own sample paths beside the shading's
``(tile, round, emitter, chunk)``: ``(tile, round, GI_TAG, sample, 0)`` for
the direction and ``(tile, round, GI_TAG, sample, 1, emitter, chunk)`` for
the child's light chunks, ``GI_TAG`` negative like no emitter index.

Gradients: each round's trace + shade is a rematerialised region
(core/remat.py), so across rounds a tile keeps only each round's inputs;
the stats, the break, the stack and the z update stay outside it, and a
recompute counts nothing twice.  Each GI sample is a region of its own
inside its round's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c_raytracer_tpu_torch.core import remat
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.render import shading
from c_raytracer_tpu_torch.render.config import GI_PATH, RenderConfig
from c_raytracer_tpu_torch.scene import types as T

GI_TAG = -1   # the GI draws' path element after (tile, round)
STAT_KEYS = ("main_rays", "shadow_rays", "gi_rays", "children_pushed",
             "dropped", "shadow_spill_max", "visit_spill_max")


def _trace(ix, o: V3, d: V3, inside=None):
    """Intersection step with the inside-object re-test (render.c:143-148):
    a ray inside object ``inside`` (P,) tests that object first and takes
    its hit even if other geometry is closer; -1 for none.  ``inside=None``
    skips the re-test (chain rays never enter objects).  Returns (t, gid,
    mat, normal V3, visit_spill (P,)): the closest-hit sweep's per-lane
    truncation count, 0 on the exhaustive dense route."""
    tc, gc, mc, nc, sp = ix.closest(o, d, with_spill=True)
    if inside is None:
        return tc, gc, mc, nc, sp
    ti, hi, ni = ix.retest(o, d, inside)
    use_inside = (inside >= 0) & hi
    t = torch.where(use_inside, ti, tc)
    gid = torch.where(use_inside, inside, gc)
    mat_in = ix.ds.mat_idx[inside.clamp(0, ix.ds.mat_idx.shape[0] - 1)]
    mat = torch.where(use_inside, mat_in, mc)
    return t, gid, mat, v3m.where(use_inside, ni, nc), sp


def _gi_sample(ix, static, cfg, skey, hit_pt: V3, normal: V3, eps,
               lane_ok, delta):
    """One hemisphere sample of path GI at every lane: direction, a
    one-bounce trace and a basic shade, weighted by delta·cos and the
    child's own segment attenuation, zero where ``lane_ok`` is False or
    the child misses.  Returns (colour V3 (P,), shadow spill, the lanes'
    visit spill)."""
    sdir, cos = shading.sample_hemisphere(skey.fold_in(0), normal, eps)
    if torch.is_grad_enabled():
        # a lane that takes no sample traces the padding's zero ray, as a
        # dead chain does: its drifting child would meet 0·inf in the
        # backward
        hit_pt, sdir = (v3m.where(lane_ok, v, 0.0) for v in (hit_pt, sdir))
    ct, cgid, cmat, cn, csp = _trace(ix, hit_pt, sdir)
    child, caux = shading.shade_basic(ix, static, cfg, skey.fold_in(1),
                                      hit_pt, sdir, ct, cgid, cmat, cn,
                                      lane_ok)
    child = shading.attenuate_segment(cfg, child * (delta * cos), ct)
    child = v3m.where(lane_ok & (cgid >= 0), child, 0.0)
    return child, caux["shadow_spill"], torch.where(lane_ok, csp, 0).max()


def _may_skip(ix) -> bool:
    """Whether a GI sample that no lane takes may be skipped: everywhere
    but under union shadows, whose guard counts the lists of every lane,
    the discarded ones too (as the JAX package does)."""
    return not (ix.use_shared_shadows and ix.resolved_shadow_mode == "union")


def _gi_path(ix, static, cfg, key, hit_pt: V3, normal: V3, gid, is_outside,
             remaining, active_hit, primary_round: bool):
    """Path-traced GI (render.c:238-287): ``samples_per_pixel`` hemisphere
    samples at primary hits and one at secondary hits, each weighted by
    δ·cosθ, δ = 1/spp at primaries and ``gi_chunk_weight`` at secondaries.

    Sample ``i`` draws under ``key.fold_in(GI_TAG).fold_in(off + i)``,
    ``off = gi_sample_offset``; a chunk with an offset runs its primary
    lanes only, so that chunk renders evaluate disjoint ranges of one
    sample set.  ``primary_round`` says whether any lane may be primary:
    a sample that no lane can take is skipped where skipping cannot change
    the stats (``_may_skip``).  Returns (colour V3 (P,), shadow spill, visit
    spill)."""
    dev = hit_pt.x.device
    spp, off = cfg.samples_per_pixel, cfg.gi_sample_offset
    is_primary = remaining == cfg.max_bounces
    eps = ix.ds.prim_eps[gid.clamp(min=0)]
    gi_active = active_hit & is_outside & (remaining > 0)
    w_primary = float(np.float32(1.0) / np.float32(spp))
    w_secondary = float(np.float32(cfg.gi_chunk_weight))
    if isinstance(is_primary, bool):
        delta = w_primary if is_primary else w_secondary
    else:
        delta = torch.where(is_primary, w_primary, w_secondary)
    may_skip = _may_skip(ix)

    acc = v3m.full(hit_pt.x.shape, 0.0, device=dev)
    ss = torch.zeros((), dtype=torch.int32, device=dev)
    vs = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(max(spp, 1)):
        # secondaries (one sample, i == 0) belong to the offset-0 chunk
        only_primary = i > 0 or off != 0
        if only_primary and may_skip and not primary_round:
            continue
        lane_ok = gi_active & (is_primary if only_primary else True)
        child, c_ss, c_vs = remat.checkpoint(
            cfg, _gi_sample, ix, static, cfg,
            key.fold_in(GI_TAG).fold_in(off + i), hit_pt, normal, eps,
            lane_ok, delta)
        acc = acc + child
        ss = torch.maximum(ss, c_ss)
        vs = torch.maximum(vs, c_vs)
    return acc, ss, vs


def _round_shade(ix, static, cfg, key, ro: V3, rd: V3, rkr: V3, remaining,
                 active, inside=None, primary_round=True):
    """Trace + shade + child spawn for one round, drawing under the round's
    ``key``.  ``remaining`` is an int (chain: the same depth on every
    lane) or (P,); ``inside`` (P,) turns on the stack's re-test and
    refraction children; ``primary_round`` whether any lane may be a
    primary ray (path GI skips the samples of primaries otherwise).
    Returns a dict of per-lane results."""
    ds = ix.ds
    t, gid, mat, normal, tr_spill = _trace(ix, ro, rd, inside)
    hit = gid >= 0
    active_hit = active & hit
    visit_spill = torch.where(active, tr_spill, 0).max()

    obj_color, aux = shading.shade_basic(
        ix, static, cfg, key, ro, rd, t, gid, mat, normal, active_hit)
    shadow_spill = aux["shadow_spill"]

    if cfg.gi_model == GI_PATH:
        gi_color, gi_ss, gi_vs = _gi_path(
            ix, static, cfg, key, aux["hit_pt"], normal, gid,
            aux["is_outside"], remaining, active_hit, primary_round)
        obj_color = obj_color + gi_color
        shadow_spill = torch.maximum(shadow_spill, gi_ss)
        visit_spill = torch.maximum(visit_spill, gi_vs)
    else:   # ambient GI (render.c:232-236)
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
    if inside is not None:   # a ray leaving an object reflects no further
        push_refl = push_refl & (inside != gid)
    refl_d = shading.reflect_dir(rd, normal, aux["b"])
    out = dict(t=t, gid=gid, hit=hit, active_hit=active_hit,
               contrib=contrib, z_val=z_val, hit_pt=aux["hit_pt"],
               push_refl=push_refl, refl_d=refl_d, refl_kr=refl_kr,
               visit_spill=visit_spill, shadow_spill=shadow_spill)
    if inside is not None:
        refr_kt = rkr * v3m.rows(ds.materials.kt, mat)
        ior = ds.materials.refractive_index[mat]
        refr_d, refr_valid = shading.refract_dir(
            rd, normal, aux["b"], aux["is_outside"], ior)
        out.update(push_refr=(can_bounce & ds.mat_transparent[mat]
                              & refr_valid
                              & (v3m.magsqr(refr_kt)
                                 > cfg.min_light_intensity_sqr)),
                   refr_d=refr_d, refr_kt=refr_kt)
    return out


def _stat_weights(static: T.SceneStatic, cfg: RenderConfig):
    """Per-hit shadow rays (emitters × sample counts, render.c:170-176)
    and GI rays per primary/secondary hit."""
    shadow_rays_per_hit = float(sum(
        static.num_lights[e] for e in static.emitter_prims))
    gi_per_secondary = 1.0 if cfg.gi_model == GI_PATH else 0.0
    gi_per_primary = (float(cfg.samples_per_pixel)
                      if cfg.gi_model == GI_PATH else 0.0)
    return shadow_rays_per_hit, gi_per_primary, gi_per_secondary


def _render_chain(ix, static: T.SceneStatic, cfg: RenderConfig, key, o: V3,
                  d: V3, *, with_stats: bool):
    P, dev = o.x.shape, o.x.device
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
        r = remat.checkpoint(cfg, _round_shade, ix, static, cfg,
                             key.fold_in(round_i), ro, rd, rkr, remaining,
                             live, None, is_primary)
        color = color + r["contrib"]
        if is_primary:
            z = torch.where(live, r["z_val"], z)

        live2 = r["push_refl"]
        n_hit = r["active_hit"].sum(dtype=torch.float64)
        stats[0] += live.sum(dtype=torch.float64)
        stats[1] += n_hit * sh_w
        stats[2] += n_hit * (gi_p if is_primary else gi_s)
        stats[3] += live2.sum(dtype=torch.float64)
        # stats[4] (stack drops) stays 0: the chain has no stack
        stats[5] = torch.maximum(stats[5],
                                 r["shadow_spill"].to(torch.float64))
        stats[6] = torch.maximum(stats[6], r["visit_spill"].to(torch.float64))
        ro, rd, rkr = r["hit_pt"], r["refl_d"], r["refl_kr"]
        if torch.is_grad_enabled():
            # under autograd a chain that died carries the zero ray of the
            # tile's padding from here on.  Its own ray goes on bouncing
            # unmasked, its direction drifting off unit length round by
            # round (0.33-1.02 after 10 rounds on the dense stand-in at
            # 1024²); its values, masked in the forward, still meet zero
            # cotangents in the backward, and there 0·inf made that
            # frame's gradients NaN, as the JAX package's are.  Dead lanes
            # add nothing to the frame or the stats either way, so a frame
            # without gradients keeps the rays and spares the selects.
            ro, rd, rkr = (v3m.where(live2, v, 0.0) for v in (ro, rd, rkr))
        live = live2
    return _finish(color, z, stats, with_stats)


@dataclasses.dataclass(frozen=True)
class RayStack:
    """Per-pixel LIFO of pending rays: V3 fields of (S, P) components,
    ``remaining`` and ``inside`` (S, P), ``count`` (P,) the depth."""

    o: V3
    d: V3
    kr: V3
    remaining: torch.Tensor   # (S, P) int64 bounces left
    inside: torch.Tensor      # (S, P) int64 gid of the enclosing object, -1
    count: torch.Tensor       # (P,) int64


def _stack_init(o: V3, d: V3, max_bounces: int, stack_size: int) -> RayStack:
    """Each pixel's primary ray in slot 0; the other slots zero."""
    S, (P,), dev = stack_size, o.x.shape, o.x.device
    slot0 = (torch.arange(S, device=dev) == 0)[:, None]

    def put0(v):
        return torch.where(slot0, v, 0.0)
    return RayStack(
        o=o.map(put0), d=d.map(put0),
        kr=V3(*(put0(torch.ones(P, device=dev)) for _ in range(3))),
        remaining=torch.where(slot0, max_bounces, 0).expand(S, P),
        inside=torch.full((S, P), -1, dtype=torch.int64, device=dev),
        count=torch.ones(P, dtype=torch.int64, device=dev))


def _stack_pop(st: RayStack):
    """Pop each pixel's top ray: ((o, d, kr, remaining, inside), active,
    stack).  A pixel with an empty stack pops slot 0 and is not active."""
    S = st.remaining.shape[0]
    active = st.count > 0
    top = torch.clamp(st.count - 1, min=0)
    onehot = torch.arange(S, device=top.device)[:, None] == top[None]

    def take(f):
        return torch.where(onehot, f, 0).sum(0)
    ray = (st.o.map(take), st.d.map(take), st.kr.map(take),
           take(st.remaining), take(st.inside))
    return ray, active, dataclasses.replace(st, count=st.count - active.long())


def _stack_push(st: RayStack, push, o: V3, d: V3, kr: V3, remaining,
                inside) -> RayStack:
    """Push one ray per pixel where ``push``; a full stack drops it (the
    bounded stack replaces the reference's unbounded recursion, and the
    caller counts the drops)."""
    S = st.remaining.shape[0]
    ok = push & (st.count < S)
    onehot = ((torch.arange(S, device=ok.device)[:, None] == st.count[None])
              & ok[None])

    def put(f, v):
        return torch.where(onehot, v[None], f)
    return RayStack(
        o=V3(*map(put, st.o, o)), d=V3(*map(put, st.d, d)),
        kr=V3(*map(put, st.kr, kr)),
        remaining=put(st.remaining, remaining),
        inside=put(st.inside, inside), count=st.count + ok.long())


def _render_stack(ix, static: T.SceneStatic, cfg: RenderConfig, key, o: V3,
                  d: V3, *, with_stats: bool):
    P, dev = o.x.shape, o.x.device
    sh_w, gi_p, gi_s = _stat_weights(static, cfg)
    st = _stack_init(o, d, cfg.max_bounces, cfg.stack_size)
    color = v3m.full(P, 0.0, device=dev)
    z = torch.zeros(P, dtype=torch.float32, device=dev)
    stats = torch.zeros(len(STAT_KEYS), dtype=torch.float64, device=dev)
    no_inside = torch.full(P, -1, dtype=torch.int64, device=dev)

    for round_i in range(cfg.resolved_rounds(True)):
        (ro, rd, rkr, remaining, inside), active, st = _stack_pop(st)
        if not bool(active.any()):
            break  # every stack is empty: the remaining rounds do no work
        # every pixel's primary ray is popped in round 0, and every pushed
        # ray is a secondary one
        r = remat.checkpoint(cfg, _round_shade, ix, static, cfg,
                             key.fold_in(round_i), ro, rd, rkr, remaining,
                             active, inside, round_i == 0)
        color = color + r["contrib"]
        is_primary = active & (remaining == cfg.max_bounces)
        z = torch.where(is_primary, r["z_val"], z)

        # refraction first, so that reflection is popped first (the
        # reference's depth-first order)
        pre = st.count
        st = _stack_push(st, r["push_refr"], r["hit_pt"], r["refr_d"],
                         r["refr_kt"], remaining - 1, r["gid"])
        st = _stack_push(st, r["push_refl"], r["hit_pt"], r["refl_d"],
                         r["refl_kr"], remaining - 1, no_inside)
        n_hit = r["active_hit"].sum(dtype=torch.float64)
        n_primary_hit = (r["active_hit"] & is_primary).sum(
            dtype=torch.float64)
        pushed = (st.count - pre).sum(dtype=torch.float64)
        wanted = (r["push_refr"].sum(dtype=torch.float64)
                  + r["push_refl"].sum(dtype=torch.float64))
        stats[0] += active.sum(dtype=torch.float64)
        stats[1] += n_hit * sh_w
        stats[2] += n_hit * gi_s + n_primary_hit * (gi_p - gi_s)
        stats[3] += pushed
        stats[4] += wanted - pushed
        stats[5] = torch.maximum(stats[5],
                                 r["shadow_spill"].to(torch.float64))
        stats[6] = torch.maximum(stats[6], r["visit_spill"].to(torch.float64))
    return _finish(color, z, stats, with_stats)


def _finish(color: V3, z, stats, with_stats):
    color = v3m.to_aos(color)
    if with_stats:
        return color, z, dict(zip(STAT_KEYS, stats.unbind()))
    return color, z


def render_wavefront(ix, static: T.SceneStatic, cfg: RenderConfig, key, o,
                     d, *, with_stats=False):
    """Render one tile of primary rays: the stack integrator when a
    material is transparent, the chain otherwise.

    ``ix`` is the frame's intersector (``accel.intersect.make_intersector``);
    o, d: (P, 3) primary origins/directions; ``key`` a ``rng.SampleKey``
    naming the tile.  Returns (color (P, 3), zbuffer (P,)) and, with
    ``with_stats``, a dict of ray counts (0-d float64 tensors) under the
    JAX package's keys."""
    # the stackless chain where refraction cannot fire: the same frame
    render = _render_stack if any(static.is_transparent) else _render_chain
    return render(ix, static, cfg, key, v3m.from_aos(o), v3m.from_aos(d),
                  with_stats=with_stats)

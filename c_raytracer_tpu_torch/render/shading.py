"""Lighting model, as in ``c_raytracer_tpu.render.shading``: emission,
soft-shadow direct lighting from sphere and triangle emitters, Phong/Blinn
specular, attenuation (render.c:158-229, 291-314), the refraction
direction (render.c:319-337) and the path-GI hemisphere sample
(render.c:238-283).

The reference's idiosyncrasies are kept (SURVEY.md §3.5): direct light only
on outside hits, blocked samples contribute nothing, light attenuation
divides by (offset + |d|) or (offset + |d|²) but segment attenuation by
(offset + t) or (offset + t)², specular through C powf/fmaxf semantics,
and the sphere-light direction flip of object.c:293-304.

Light-sample batches are (lc, P) with the sample axis leading.  Per-lane
material values are gathered from the tiny material tables by index
(``v3.rows``), the natural GPU form of the JAX package's unrolled selects.

Direct light goes through the fused chunk (render/fused_shadow.py) for every
emitter it can serve (``fused_eligible``) — the JAX package's opt-in for
its fused kernel has no counterpart here.  Every other emitter takes the
chunk loop of the JAX package's non-fused branch: occlusion from the
intersector's shared-origin sweep (``shadow_query``, cluster scenes) or
from one ``any_counts`` query per chunk, then shading.  Each chunk's uniforms
are drawn once, under the path ``(tile, round, emitter, chunk)``, and serve
both the occlusion and the shading.

Gradients: each light chunk is a rematerialised region (core/remat.py), its
draw inside it, so the backward draws again instead of keeping (lc, P)
samples.  The occlusion sweeps run without autograd and their masks are the
frame's saved residual: the recompute reads them and never sweeps again.
The samples' directions and distances and the cosine and ``powf`` terms of
the chunk loop are the named residuals ``shadow_samples`` and
``shade_terms``, kept too when ``cfg.remat_names`` asks for them; the fused
route names nothing, as in the JAX package, whose draws live inside its
kernel.

Spans (core/tracing.py): ``crt.shade.emitter`` around each emitter's direct
light, ``crt.shade.chunk`` around each light chunk (kernel 2's call, or
the chunk loop's occlusion and shading), inside the chunk's region so that
a recompute shows it too.
"""

from __future__ import annotations

import numpy as np
import torch

from c_raytracer_tpu_torch.core import cmath, remat, tracing
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import PI, V3
from c_raytracer_tpu_torch.render.config import (
    ATTEN_LINEAR, ATTEN_NONE, REFLECTION_PHONG, RenderConfig)
from c_raytracer_tpu_torch.scene import types as T
from c_raytracer_tpu_torch.textures import texture_color_soa

PI2 = float(np.float32(2.0) * np.float32(PI))


def attenuate_light(cfg: RenderConfig, intensity: V3, dist) -> V3:
    """Incoming-light attenuation (render.c:191-200)."""
    if cfg.light_attenuation == ATTEN_NONE:
        return intensity
    off = float(np.float32(cfg.attenuation_offset))
    if cfg.light_attenuation == ATTEN_LINEAR:
        return intensity * (1.0 / (off + dist))
    return intensity * (1.0 / (off + dist * dist))


def attenuate_segment(cfg: RenderConfig, color: V3, t) -> V3:
    """Per-segment attenuation of the accumulated hit color
    (render.c:292-301); note sqr divides by (offset+t)²."""
    if cfg.light_attenuation == ATTEN_NONE:
        return color
    off = float(np.float32(cfg.attenuation_offset))
    if cfg.light_attenuation == ATTEN_LINEAR:
        return color * (1.0 / (off + t))
    s = off + t
    return color * (1.0 / (s * s))


def reflect_dir(d: V3, n: V3, b) -> V3:
    """Mirror direction: d − 2(n·d)n (render.c:313-314)."""
    return d - n * (2.0 * b)


def refract_dir(d: V3, n: V3, b, is_outside, ior):
    """Snell rotation in the plane of incidence (render.c:324-337).

    Returns (direction, valid).  The reference makes NaN directions on
    total internal reflection and at exactly normal incidence; those lanes
    are marked invalid instead, and the arithmetic stays NaN-free so that
    gradients stay finite: ``|b|`` is clamped below 1, and each of arccos
    and arcsin sits in a double ``where`` (a single one would send the
    masked lanes' infinite slope, times a zero cotangent, into NaN)."""
    ab = torch.abs(b)
    interior = ab < 1.0
    incident = torch.where(interior,
                           torch.arccos(torch.where(interior, ab, 0.5)), 0.0)
    ratio = torch.where(is_outside, 1.0 / ior, ior)
    sin_r = torch.sin(incident) * ratio
    tir = torch.abs(sin_r) > 1.0
    sin_interior = torch.abs(sin_r) < 1.0
    refracted = torch.where(
        sin_interior, torch.arcsin(torch.where(sin_interior, sin_r, 0.5)),
        torch.where(sin_r > 0, PI / 2, -PI / 2))
    delta = refracted - incident
    cr = v3m.cross(d, n)
    m = v3m.safe_mag(cr)
    degenerate = m == 0.0
    c = cr * (1.0 / torch.where(degenerate, 1.0, m))
    c = v3m.where(is_outside, c, -c)
    f = v3m.cross(c, d)
    out = d * torch.cos(delta) + f * torch.sin(delta)
    om = v3m.safe_mag(out)
    out = out * (1.0 / torch.where(om == 0.0, 1.0, om))
    return out, ~(tir | degenerate)


def sample_hemisphere(key, normal: V3, eps):
    """One path-GI direction per lane (render.c:281-283), drawn under
    ``key`` as (2, P) uniforms and turned by the rotation that takes +Y to
    the normal (render.c:240-268); where the normal points down, within
    the hit object's epsilon ``eps`` (P,), the 180° X-flip takes its place.
    The azimuth spans the reference's half circle, u·π.  Returns (dir V3,
    cos = n·dir)."""
    u = key.uniform((2,) + tuple(normal.x.shape))
    inclination = torch.arccos(u[0] * 2.0 - 1.0)
    azimuth = u[1] * PI
    lo = v3m.spherical_to_cartesian(1.0, inclination, azimuth)
    nx, ny, nz = normal
    down = (ny - eps) < -1.0
    mul = 1.0 / torch.where(down, 1.0, 1.0 + ny)
    rx = V3(1.0 - nx * nx * mul, nx, -nx * nz * mul)
    ry = V3(-nx, 1.0 - (nx * nx + nz * nz) * mul, -nz)
    rz = V3(-nx * nz * mul, nz, 1.0 - nz * nz * mul)
    d = V3(v3m.dot(rx, lo), v3m.dot(ry, lo), v3m.dot(rz, lo))
    d = v3m.where(down, V3(lo.x, -lo.y, -lo.z), d)
    return d, v3m.dot(normal, d)


def _sphere_light_point_from_u(u, center: V3, radius, hit_pt: V3):
    """Sphere-surface points (object.c:293-304) from pre-drawn uniforms
    u (2, lc, P): the reference's direction flip fires whenever
    dot(center − point, dir) ≠ 0, i.e. essentially always."""
    inclination = u[0] * PI2
    azimuth = u[1] * PI2
    ldir = v3m.spherical_to_cartesian(radius, inclination, azimuth)
    toward = center - hit_pt                       # (P,), against (lc, P)
    flip = v3m.dot(toward.map(lambda a: a[None]), ldir) != 0.0
    ldir = v3m.where(flip, -ldir, ldir)
    return ldir + center


def _sphere_light_point(key, center: V3, radius, hit_pt: V3, lc):
    """Random sphere-surface points (object.c:293-304).  Returns V3
    (lc, P)."""
    u = key.uniform((2, lc) + tuple(hit_pt.x.shape))
    return _sphere_light_point_from_u(u, center, radius, hit_pt)


def _triangle_light_point_from_u(u, v0: V3, e1: V3, e2: V3):
    """Uniform barycentric points (object.c:403-419) from pre-drawn
    uniforms u (2, lc, P).  Returns V3 (lc, P)."""
    p, q = u[0], u[1]
    over = p + q > 1.0
    p = torch.where(over, 1.0 - p, p)
    q = torch.where(over, 1.0 - q, q)
    return v0 + e1 * p + e2 * q


def _light_dirs(ds, static, ckey, egid: int, hit_pt: V3, lc):
    """One chunk's sample directions toward emitter ``egid``, drawn under
    ``ckey``: (ldir V3 (lc, P), ldist (lc, P)), computed from the draw on
    as the residual ``shadow_samples`` (core/remat.py)."""
    u = ckey.uniform((2, lc) + tuple(hit_pt.x.shape))
    if egid < static.n_spheres:
        center, radius = v3m.splat(ds.sph_center[egid]), ds.sph_radius[egid]
    else:
        ti = egid - static.n_spheres
        v0, e1, e2 = (v3m.splat(x[ti])
                      for x in (ds.tri_v0, ds.tri_e1, ds.tri_e2))
    with remat.named(remat.SHADOW_SAMPLES):
        if egid < static.n_spheres:
            lp = _sphere_light_point_from_u(u, center, radius, hit_pt)
        else:
            lp = _triangle_light_point_from_u(u, v0, e1, e2)
        lvec = lp - hit_pt.map(lambda a: a[None])
        ldist = v3m.safe_mag(lvec)
        ldir = lvec * (1.0 / torch.where(ldist == 0.0, 1.0, ldist))
    return ldir, ldist


def fused_eligible(static: T.SceneStatic, egid: int) -> bool:
    """Whether the fused chunk serves this emitter: a dense opaque scene
    (no triangles, no transparent material) and a sphere emitter — the
    scene conditions of the JAX package's ``_fused_eligible``; its TPU
    conditions (platform, lc % 8, block divisibility) do not apply."""
    return (not static.n_triangles and not any(static.is_transparent)
            and egid < static.n_spheres)


@tracing.spanned("shade.chunk")
def _fused_chunk(ckey, n_valid, statics, px, scal_f):
    """One chunk of the fused route: its draw and kernel 2 -> (3, P)."""
    # imported here: fused_shadow imports this module for its plain version
    from c_raytracer_tpu_torch.render import fused_shadow

    u = ckey.uniform((2, statics["lc"], px.shape[1]))
    return fused_shadow.fused_chunk(u, px, scal_f, n_valid, **statics)


def _fused_emitter(ds, static, cfg, ekey, egid, num_lights, lc, nchunks,
                   hit_pt: V3, normal: V3, ray_d: V3, tex_col: V3, ksv: V3,
                   shin, okf) -> V3:
    """One emitter's direct light through the fused chunk (kernel 2)."""
    dev = hit_pt.x.device
    P = hit_pt.x.shape[0]
    e_mat = static.material_index[egid]
    inv_nl = float(np.float32(1.0) / np.float32(num_lights))
    intensity = ds.materials.ke[e_mat] * inv_nl
    px = torch.stack([
        hit_pt.x, hit_pt.y, hit_pt.z,
        normal.x, normal.y, normal.z,
        ray_d.x, ray_d.y, ray_d.z,
        tex_col.x, tex_col.y, tex_col.z,
        ksv.x, ksv.y, ksv.z, shin, okf.to(torch.float32)], 0)
    # built from device tensors only: no host-to-device copy (and so no
    # stream sync) per call
    scal_f = torch.cat([
        ds.sph_center[egid], ds.sph_radius[egid:egid + 1], intensity,
        torch.full((1,), cfg.attenuation_offset, dtype=torch.float32,
                   device=dev),
        torch.cat([ds.sph_center, ds.sph_radius[:, None],
                   ds.sph_eps[:, None]], 1).reshape(-1),
        torch.cat([ds.pln_n, ds.pln_d[:, None],
                   ds.pln_eps[:, None]], 1).reshape(-1)])
    statics = dict(lc=lc, ns=static.n_spheres, npl=static.n_planes,
                   egid=egid, phong=cfg.reflection_model == REFLECTION_PHONG,
                   atten_kind=cfg.light_attenuation)
    total = v3m.full((P,), 0.0, device=dev)
    for chunk_i in range(nchunks):
        out = remat.checkpoint(cfg, _fused_chunk, ekey.fold_in(chunk_i),
                               num_lights - chunk_i * lc, statics, px, scal_f)
        total = total + V3(out[0], out[1], out[2])
    return total


@tracing.spanned("shade.chunk")
def _shade_chunk(ix, static, cfg, ckey, egid, real, intensity: V3,
                 hit_pt: V3, nrm_b: V3, rd_b: V3, tex_col: V3, ksv: V3,
                 shin, blocked, counts, drawn):
    """One chunk of the non-fused route: its samples' occlusion and
    shading.  ``real`` (lc, P) marks the sample lanes that count (shaded
    pixels, samples below num_lights); ``nrm_b``, ``rd_b`` are the normal
    and ray direction broadcast to (1, P); ``blocked`` and ``counts`` are
    the chunk's occlusion mask and blocker counts (None in an opaque
    scene) from the shared sweep, or None for a per-chunk ``any_counts``
    query; ``drawn`` the chunk's (ldir, ldist) when the caller drew them,
    else None and the draw is made here.  Returns (V3 (P,) sum over the
    chunk's samples, the per-ray sweep's spill or None)."""
    if drawn is None:
        drawn = _light_dirs(ix.ds, static, ckey, egid, hit_pt, real.shape[0])
    ldir, ldist = drawn
    a = v3m.dot(ldir, nrm_b)
    spill = None
    if blocked is None:
        def sweep():
            # the per_ray sweep's truncation guard, over real sample lanes
            # of shaded pixels only
            b, cnt, qspill = ix.any_counts(hit_pt.map(lambda x: x[None]),
                                           ldir, ldist, egid,
                                           with_spill=True)
            return b, cnt, torch.where(real, qspill, 0).max()
        blocked, counts, spill = remat.saved_occlusion(ix.saved_occlusion,
                                                       ckey.path, sweep)

    if counts is not None:   # transparent blockers tint the light
        intensity = intensity * ix.tint(counts)
    incoming = attenuate_light(cfg, intensity, ldist)
    if cfg.reflection_model == REFLECTION_PHONG:
        reflected = nrm_b * (2.0 * a) - ldir
        spec_mul = -v3m.dot(reflected, rd_b)
    else:  # Blinn half-vector variant (render.c:215-220)
        hv = rd_b - ldir
        hm = v3m.safe_mag(hv)
        reflected = hv * (1.0 / torch.where(hm == 0.0, 1.0, hm))
        spec_mul = -v3m.dot(nrm_b, reflected)
    with remat.named(remat.SHADE_TERMS):
        cos_d = cmath.fmaxf_zero(a)
        spec_p = cmath.fmax0_powf(spec_mul, shin[None])
    diffuse = tex_col.map(lambda x: x[None]) * incoming * cos_d
    spec = ksv.map(lambda x: x[None]) * incoming * spec_p
    contrib = v3m.where(real & ~blocked, diffuse + spec, 0.0)
    return contrib.map(lambda x: x.sum(0)), spill


def direct_light(ix, static: T.SceneStatic, cfg: RenderConfig, key,
                 hit_pt: V3, normal: V3, ray_d: V3, gid, mat, is_outside,
                 tex_col: V3, active):
    """Soft-shadow direct lighting over all emitters (render.c:170-229).

    Per emitter: ke/num_lights intensity per sample, tinted by the kt of
    the transparent blockers, num_lights samples in chunks of
    ``cfg.light_chunk``, each chunk's (lc, P) uniforms drawn from
    ``key.fold_in(emitter).fold_in(chunk)``.  All per-lane inputs are (P,).
    Returns (V3 (P,) summed contribution, shadow_spill, a 0-d int tensor):
    the worst visit truncation of the union lists (over all pixels, as the
    JAX package counts it) and of the per-chunk cluster queries
    (shadow_mode "per_ray", in range, over the real sample lanes of shaded
    pixels); 0 where the sweep cannot truncate (dense, shared capsule)."""
    ds = ix.ds
    dev = hit_pt.x.device
    P = hit_pt.x.shape[0]
    total = v3m.full((P,), 0.0, device=dev)
    spill_max = torch.zeros((), dtype=torch.int32, device=dev)
    ksv = v3m.rows(ds.materials.ks, mat)
    shin = ds.materials.shininess[mat]

    for e_i, egid in enumerate(static.emitter_prims):
        num_lights = static.num_lights[egid]
        if num_lights == 0:
            continue  # zero-sample emitter: loop never runs (render.c:176)
        with tracing.span("shade.emitter", egid=egid):
            ekey = key.fold_in(e_i)
            lc = min(cfg.light_chunk, -(-num_lights // 8) * 8)
            nchunks = -(-num_lights // lc)
            shaded = active & is_outside & (gid != egid)       # (P,)
            if fused_eligible(static, egid):
                total = total + _fused_emitter(
                    ds, static, cfg, ekey, egid, num_lights, lc, nchunks,
                    hit_pt, normal, ray_d, tex_col, ksv, shin, shaded)
                continue

            e_mat = static.material_index[egid]
            inv_nl = float(np.float32(1.0) / np.float32(num_lights))
            intensity = v3m.splat(ds.materials.ke[e_mat] * inv_nl)

            blocked_all = counts_all = dirs = None
            if ix.use_shared_shadows:
                # shared-origin sweep: every chunk's occlusion in one pass with
                # per-pixel visit lists; the draws, made once here, serve the
                # sweep and the shading, and the recompute draws them again
                dirs = [_light_dirs(ds, static, ekey.fold_in(c), egid, hit_pt,
                                    lc) for c in range(nchunks)]

                def sweep(_egid=egid, _dirs=dirs, _nc=nchunks, _lc=lc,
                          _live=shaded):
                    elo, ehi = ix.emitter_bounds(_egid)
                    return ix.shadow_query(hit_pt, elo, ehi, _dirs.__getitem__,
                                           _egid, _nc, _lc, live=_live)
                blocked_all, counts_all, sp = remat.saved_occlusion(
                    ix.saved_occlusion, ekey.path, sweep)
                spill_max = torch.maximum(spill_max, sp)

            lane_idx = torch.arange(lc, device=dev)[:, None]
            nrm_b = normal.map(lambda a: a[None])
            rd_b = ray_d.map(lambda a: a[None])
            for chunk_i in range(nchunks):
                # the padded tail of the last chunk never contributes
                real = shaded[None] & (chunk_i * lc + lane_idx < num_lights)
                contrib, sp = remat.checkpoint(
                    cfg, _shade_chunk, ix, static, cfg, ekey.fold_in(chunk_i),
                    egid, real, intensity, hit_pt, nrm_b, rd_b, tex_col, ksv,
                    shin, None if dirs is None else blocked_all[chunk_i],
                    None if counts_all is None else counts_all[chunk_i],
                    None if dirs is None else dirs[chunk_i])
                total = total + contrib
                if sp is not None:
                    spill_max = torch.maximum(spill_max, sp)
    return total, spill_max


def shade_basic(ix, static: T.SceneStatic, cfg: RenderConfig, key,
                o: V3, d: V3, t, gid, mat, normal: V3, active):
    """Emission + direct lighting for a batch of hits.  Returns
    (color V3 (P,), aux dict)."""
    ds = ix.ds
    hit = gid >= 0
    active = active & hit
    # miss lanes carry t=FLT_MAX; clamp them so hit points stay finite
    t = torch.where(hit, t, 1.0)
    hit_pt = o + d * t
    b = v3m.dot(normal, d)
    is_outside = cmath.signbit(b)

    tex_col = texture_color_soa(ds.materials, static, mat, hit_pt)

    color = v3m.rows(ds.materials.ke, mat)  # emittance (render.c:164)
    direct, shadow_spill = direct_light(ix, static, cfg, key, hit_pt, normal,
                                        d, gid, mat, is_outside, tex_col,
                                        active)
    color = color + direct
    color = v3m.where(active, color, 0.0)
    aux = dict(hit_pt=hit_pt, mat=mat, b=b, is_outside=is_outside,
               tex_col=tex_col, hit=hit, shadow_spill=shadow_spill)
    return color, aux

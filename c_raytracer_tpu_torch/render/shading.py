"""Lighting model, opaque part, as in ``c_raytracer_tpu.render.shading``:
emission, soft-shadow direct lighting from sphere and triangle emitters,
Phong/Blinn specular and attenuation (render.c:158-229, 291-314).

The reference's idiosyncrasies are kept (SURVEY.md §3.5): direct light only
on outside hits, blocked samples contribute nothing, transparent blockers
tint the light by their kt, light attenuation divides by (offset + |d|) or
(offset + |d|²) but segment attenuation by (offset + t) or (offset + t)²,
specular through C powf/fmaxf semantics, and the sphere-light direction
flip of object.c:293-304.

Light-sample batches are (lc, P) with the sample axis leading.  Per-lane
material values are gathered from the tiny material tables by index
(``v3.rows``), the natural GPU form of the JAX package's unrolled selects.

Direct light goes through the fused chunk (render/fused_shadow.py) for every
emitter it can serve (``fused_eligible``) — the JAX package's
``fused_shadow`` opt-in does not apply here.  Every other emitter takes the
chunk loop of the JAX package's non-fused branch: occlusion from the
intersector's shared-origin sweep (``shadow_query``, cluster scenes) or
from one ``any_tint`` query per chunk, then shading.  Each chunk's uniforms
are drawn once, under the path ``(tile, round, emitter, chunk)``, and serve
both the occlusion and the shading.
"""

from __future__ import annotations

import numpy as np
import torch

from c_raytracer_tpu_torch.core import cmath
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


def _triangle_light_point(key, v0: V3, e1: V3, e2: V3, hit_pt: V3, lc):
    """Uniform barycentric points (object.c:403-419).  Returns V3 (lc, P)."""
    u = key.uniform((2, lc) + tuple(hit_pt.x.shape))
    p, q = u[0], u[1]
    over = p + q > 1.0
    p = torch.where(over, 1.0 - p, p)
    q = torch.where(over, 1.0 - q, q)
    return v0 + e1 * p + e2 * q


def fused_eligible(static: T.SceneStatic, egid: int) -> bool:
    """Whether the fused chunk serves this emitter: a dense opaque scene
    (no triangles, no transparent material) and a sphere emitter — the
    scene conditions of the JAX package's ``_fused_eligible``; its TPU
    conditions (platform, lc % 8, block divisibility) do not apply."""
    return (not static.n_triangles and not any(static.is_transparent)
            and egid < static.n_spheres)


def _fused_emitter(ds, static, cfg, ekey, egid, num_lights, lc, nchunks,
                   hit_pt: V3, normal: V3, ray_d: V3, tex_col: V3, ksv: V3,
                   shin, okf) -> V3:
    """One emitter's direct light through the fused chunk (kernel 2)."""
    # imported here: fused_shadow imports this module for its plain version
    from c_raytracer_tpu_torch.render import fused_shadow

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
    total = v3m.full((P,), 0.0, device=dev)
    for chunk_i in range(nchunks):
        u = ekey.fold_in(chunk_i).uniform((2, lc, P))
        out = fused_shadow.fused_chunk(
            u, px, scal_f, num_lights - chunk_i * lc, lc=lc,
            ns=static.n_spheres, npl=static.n_planes, egid=egid,
            phong=cfg.reflection_model == REFLECTION_PHONG,
            atten_kind=cfg.light_attenuation)
        total = total + V3(out[0], out[1], out[2])
    return total


def direct_light(ix, static: T.SceneStatic, cfg: RenderConfig, key,
                 hit_pt: V3, normal: V3, ray_d: V3, gid, mat, is_outside,
                 tex_col: V3, active):
    """Soft-shadow direct lighting over all emitters (render.c:170-229).

    Per emitter: ke/num_lights intensity per sample, num_lights samples in
    chunks of ``cfg.light_chunk``, each chunk's (lc, P) uniforms drawn from
    ``key.fold_in(emitter).fold_in(chunk)``.  All per-lane inputs are (P,).
    Returns (V3 (P,) summed contribution, shadow_spill): the worst in-range
    visit truncation of the per-chunk cluster queries (shadow_mode
    "per_ray") over the real sample lanes of shaded pixels, a 0-d int
    tensor; 0 where the sweep cannot truncate (dense, shared capsule)."""
    ds = ix.ds
    dev = hit_pt.x.device
    P = hit_pt.x.shape[0]
    total = v3m.full((P,), 0.0, device=dev)
    spill_max = torch.zeros((), dtype=torch.int32, device=dev)
    phong = cfg.reflection_model == REFLECTION_PHONG
    ksv = v3m.rows(ds.materials.ks, mat)
    shin = ds.materials.shininess[mat]

    for e_i, egid in enumerate(static.emitter_prims):
        num_lights = static.num_lights[egid]
        if num_lights == 0:
            continue  # zero-sample emitter: loop never runs (render.c:176)
        ekey = key.fold_in(e_i)
        lc = min(cfg.light_chunk, -(-num_lights // 8) * 8)
        nchunks = -(-num_lights // lc)
        shaded = active & is_outside & (gid != egid)       # (P,)
        if fused_eligible(static, egid):
            total = total + _fused_emitter(
                ds, static, cfg, ekey, egid, num_lights, lc, nchunks, hit_pt,
                normal, ray_d, tex_col, ksv, shin, shaded)
            continue

        e_mat = static.material_index[egid]
        inv_nl = float(np.float32(1.0) / np.float32(num_lights))
        intensity = v3m.splat(ds.materials.ke[e_mat] * inv_nl)

        def light_dirs(chunk_i, _egid=egid, _ekey=ekey, _lc=lc):
            """The chunk's sample directions: (ldir V3 (lc, P), ldist)."""
            ckey = _ekey.fold_in(chunk_i)
            if _egid < static.n_spheres:
                lp = _sphere_light_point(
                    ckey, v3m.splat(ds.sph_center[_egid]),
                    ds.sph_radius[_egid], hit_pt, _lc)
            else:
                ti = _egid - static.n_spheres
                lp = _triangle_light_point(
                    ckey, v3m.splat(ds.tri_v0[ti]), v3m.splat(ds.tri_e1[ti]),
                    v3m.splat(ds.tri_e2[ti]), hit_pt, _lc)
            lvec = lp - hit_pt.map(lambda a: a[None])
            ldist = v3m.safe_mag(lvec)
            ldir = lvec * (1.0 / torch.where(ldist == 0.0, 1.0, ldist))
            return ldir, ldist

        shadow_all = None
        if ix.use_shared_shadows:
            # shared-origin sweep: every chunk's occlusion in one pass with
            # per-pixel visit lists; the draws are kept for the shading
            dirs = [light_dirs(c) for c in range(nchunks)]
            light_dirs = dirs.__getitem__
            elo, ehi = ix.emitter_bounds(egid)
            blocked_all, tint_all, sp = ix.shadow_query(
                hit_pt, elo, ehi, light_dirs, egid, nchunks, lc)
            shadow_all = (blocked_all, tint_all)
            spill_max = torch.clamp(spill_max, min=sp)

        lane_idx = torch.arange(lc, device=dev)[:, None]
        nrm_b = normal.map(lambda a: a[None])
        rd_b = ray_d.map(lambda a: a[None])
        for chunk_i in range(nchunks):
            ldir, ldist = light_dirs(chunk_i)
            a = v3m.dot(ldir, nrm_b)
            # the padded tail of the last chunk never contributes
            real = shaded[None] & (chunk_i * lc + lane_idx < num_lights)
            if shadow_all is None:
                blocked, tint, qspill = ix.any_tint(
                    hit_pt.map(lambda x: x[None]), ldir, ldist, egid,
                    with_spill=True)
                # the per_ray sweep's truncation guard, over real sample
                # lanes of shaded pixels only
                spill_max = torch.maximum(
                    spill_max, torch.where(real, qspill, 0).max())
            else:
                blocked = shadow_all[0][chunk_i]
                tn = shadow_all[1]
                # opaque scenes carry no tint (merged into blocked)
                tint = (V3(tn[0][chunk_i], tn[1][chunk_i], tn[2][chunk_i])
                        if tn is not None else 1.0)

            incoming = attenuate_light(cfg, intensity * tint, ldist)
            if phong:
                reflected = nrm_b * (2.0 * a) - ldir
                spec_mul = -v3m.dot(reflected, rd_b)
            else:  # Blinn half-vector variant (render.c:215-220)
                hv = rd_b - ldir
                hm = v3m.safe_mag(hv)
                reflected = hv * (1.0 / torch.where(hm == 0.0, 1.0, hm))
                spec_mul = -v3m.dot(nrm_b, reflected)
            cos_d = cmath.fmaxf_zero(a)
            spec_p = cmath.fmax0_powf(spec_mul, shin[None])
            diffuse = tex_col.map(lambda x: x[None]) * incoming * cos_d
            spec = ksv.map(lambda x: x[None]) * incoming * spec_p
            contrib = v3m.where(real & ~blocked, diffuse + spec, 0.0)
            total = total + contrib.map(lambda x: x.sum(0))
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

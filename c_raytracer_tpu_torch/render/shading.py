"""Lighting model, dense opaque part, as in ``c_raytracer_tpu.render.shading``:
emission, soft-shadow direct lighting from sphere emitters, Phong/Blinn
specular and attenuation (render.c:158-229, 291-314).

The reference's idiosyncrasies are kept (SURVEY.md §3.5): direct light only
on outside hits, blocked samples contribute nothing, light attenuation
divides by (offset + |d|) or (offset + |d|²) but segment attenuation by
(offset + t) or (offset + t)², specular through C powf/fmaxf semantics,
and the sphere-light direction flip of object.c:293-304.

Light-sample batches are (lc, P) with the sample axis leading.  Per-lane
material values are gathered from the tiny material tables by index
(``v3.rows``), the natural GPU form of the JAX package's unrolled selects.

Direct light goes through the fused chunk (render/fused_shadow.py) for every
scene it can serve — the JAX package's ``fused_shadow`` opt-in does not
apply here; scenes it cannot serve (triangle emitters, transparent
materials) raise ``NotImplementedError``.
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


def fused_eligible(static: T.SceneStatic, egid: int) -> bool:
    """Whether the fused chunk serves this emitter: a dense opaque scene
    (no triangles, no transparent material) and a sphere emitter — the
    scene conditions of the JAX package's ``_fused_eligible``; its TPU
    conditions (platform, lc % 8, block divisibility) do not apply."""
    return (not static.n_triangles and not any(static.is_transparent)
            and egid < static.n_spheres)


def direct_light(ix, static: T.SceneStatic, cfg: RenderConfig, key,
                 hit_pt: V3, normal: V3, ray_d: V3, gid, mat, is_outside,
                 tex_col: V3, active) -> V3:
    """Soft-shadow direct lighting over all emitters (render.c:170-229).

    Per emitter: ke/num_lights intensity per sample, num_lights samples in
    chunks of ``cfg.light_chunk``, each chunk one fused call on (lc, P)
    uniforms drawn from ``key.fold_in(emitter).fold_in(chunk)``.
    All per-lane inputs are (P,); returns V3 (P,)."""
    # imported here: fused_shadow imports this module for its plain version
    from c_raytracer_tpu_torch.render import fused_shadow

    ds = ix.ds
    dev = hit_pt.x.device
    P = hit_pt.x.shape[0]
    total = v3m.full((P,), 0.0, device=dev)
    phong = cfg.reflection_model == REFLECTION_PHONG
    ns, npl = static.n_spheres, static.n_planes
    ksv = v3m.rows(ds.materials.ks, mat)
    shin = ds.materials.shininess[mat]

    for e_i, egid in enumerate(static.emitter_prims):
        num_lights = static.num_lights[egid]
        if num_lights == 0:
            continue  # zero-sample emitter: loop never runs (render.c:176)
        if not fused_eligible(static, egid):
            raise NotImplementedError(
                "direct light from triangle emitters or through transparent "
                "blockers is not ported yet (ROADMAP: the non-fused "
                "direct_light)")
        e_mat = static.material_index[egid]
        inv_nl = float(np.float32(1.0) / np.float32(num_lights))
        intensity = ds.materials.ke[e_mat] * inv_nl
        ekey = key.fold_in(e_i)
        lc = min(cfg.light_chunk, -(-num_lights // 8) * 8)
        nchunks = -(-num_lights // lc)

        okf = (active & is_outside & (gid != egid)).to(torch.float32)
        px = torch.stack([
            hit_pt.x, hit_pt.y, hit_pt.z,
            normal.x, normal.y, normal.z,
            ray_d.x, ray_d.y, ray_d.z,
            tex_col.x, tex_col.y, tex_col.z,
            ksv.x, ksv.y, ksv.z, shin, okf], 0)
        # built from device tensors only: no host-to-device copy (and so
        # no stream sync) per call
        scal_f = torch.cat([
            ds.sph_center[egid], ds.sph_radius[egid:egid + 1], intensity,
            torch.full((1,), cfg.attenuation_offset, dtype=torch.float32,
                       device=dev),
            torch.cat([ds.sph_center, ds.sph_radius[:, None],
                       ds.sph_eps[:, None]], 1).reshape(-1),
            torch.cat([ds.pln_n, ds.pln_d[:, None],
                       ds.pln_eps[:, None]], 1).reshape(-1)])

        for chunk_i in range(nchunks):
            u = ekey.fold_in(chunk_i).uniform((2, lc, P))
            out = fused_shadow.fused_chunk(
                u, px, scal_f, num_lights - chunk_i * lc, lc=lc, ns=ns,
                npl=npl, egid=egid, phong=phong,
                atten_kind=cfg.light_attenuation)
            total = total + V3(out[0], out[1], out[2])
    return total


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
    direct = direct_light(ix, static, cfg, key, hit_pt, normal, d, gid, mat,
                          is_outside, tex_col, active)
    color = color + direct
    color = v3m.where(active, color, 0.0)
    aux = dict(hit_pt=hit_pt, mat=mat, b=b, is_outside=is_outside,
               tex_col=tex_col, hit=hit)
    return color, aux

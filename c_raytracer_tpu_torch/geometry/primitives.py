"""Primitive intersection for dense scenes, as in
``c_raytracer_tpu.geometry.primitives`` (its SoA hot path).

* ``DeviceScene`` — the scene's tensors on the render device: triangle
  edges and normals derived from the vertices, the per-primitive epsilon
  and material tables;
* ``closest_hit_soa`` — closest intersection over all primitives with the
  reference's exact accept rules (sphere: object.c:306-321; triangle
  Möller-Trumbore: object.c:422-441; plane: object.c:473-488), folded as a
  running minimum: planes, then spheres, then the triangles in chunks of
  ``tri_chunk`` (the first winner inside a chunk; a later primitive or
  chunk wins only on a strictly smaller t, accel.c:328), with the
  winner's material carried through the fold;
* ``any_hit_counts_soa`` — the shadow query: opaque blockers block, and
  each transparent blocker adds one to its material's count, from which
  ``tint_from_counts`` forms the light's tint Π kt (accel.c:360-387);
* ``intersect_prim_soa`` — the inside-object re-test of the stack
  integrator (render.c:143-144): one primitive per ray.

Global primitive ids run spheres, then triangles, then planes
(scene/types.py), so a plane's id is ``n_spheres + n_triangles + i``.

Transparent materials are numbered by ``tint_slots``: slot ``m`` is the
``m``-th material with ``is_transparent``.  A count of blockers per slot is
what the occlusion sweeps return: it is discrete, so the frame keeps it for
the backward (core/remat.py), and the tint, with its gradient into
``materials.kt``, is formed from it wherever it is needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.scene import types as T

FLT_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Geometry + per-primitive and material tables on a device."""

    # spheres
    sph_center: torch.Tensor   # (Ns, 3)
    sph_radius: torch.Tensor   # (Ns,)
    sph_eps: torch.Tensor      # (Ns,)
    # triangles
    tri_v0: torch.Tensor       # (Nt, 3)
    tri_e1: torch.Tensor       # (Nt, 3)  B - A (object.c:331)
    tri_e2: torch.Tensor       # (Nt, 3)  C - A
    tri_n: torch.Tensor        # (Nt, 3)  normalized cross(e1, e2)
    tri_eps: torch.Tensor      # (Nt,)
    # planes
    pln_n: torch.Tensor        # (Np, 3)
    pln_d: torch.Tensor        # (Np,)
    pln_eps: torch.Tensor      # (Np,)
    # per-global-primitive tables
    mat_idx: torch.Tensor      # (N,) int64
    prim_eps: torch.Tensor     # (N,)
    # per-material tables
    mat_reflective: torch.Tensor  # (M,) bool, static.is_reflective
    mat_transparent: torch.Tensor  # (M,) bool, static.is_transparent
    materials: T.Materials
    ambient: torch.Tensor      # (3,)


def _tri_normals(e1, e2):
    """normalize(cross(e1, e2)) with a 1e-30 floor on the magnitude,
    component by component as the JAX package rounds it."""
    nx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    ny = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    nz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    mag = v3m.sqrt(nx * nx + ny * ny + nz * nz)
    n = torch.stack([nx, ny, nz], -1)
    return n / torch.clamp(mag, min=1e-30)[:, None]


def device_scene(params: T.SceneParams, static: T.SceneStatic) -> DeviceScene:
    """Scene tensors for rendering.  ``params`` has tensor leaves on the
    render device (scene.convert.params_to_torch)."""
    dev = params.sphere_center.device
    ns, nt = static.n_spheres, static.n_triangles
    eps = torch.as_tensor(np.asarray(static.epsilon, np.float32), device=dev)
    v = params.tri_vertices.reshape(nt, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    return DeviceScene(
        sph_center=params.sphere_center, sph_radius=params.sphere_radius,
        sph_eps=eps[:ns],
        tri_v0=v[:, 0], tri_e1=e1, tri_e2=e2, tri_n=_tri_normals(e1, e2),
        tri_eps=eps[ns:ns + nt],
        pln_n=params.plane_normal, pln_d=params.plane_d,
        pln_eps=eps[ns + nt:],
        mat_idx=torch.as_tensor(np.asarray(static.material_index, np.int64),
                                device=dev),
        prim_eps=eps,
        mat_reflective=torch.as_tensor(static.is_reflective, device=dev),
        mat_transparent=torch.as_tensor(static.is_transparent, device=dev),
        materials=params.materials,
        ambient=params.ambient,
    )


def _safe_sqrt(x):
    """sqrt(max(x, 0)) with the JAX package's double-where."""
    ok = x > 0
    return torch.where(ok, v3m.sqrt(torch.where(ok, x, 1.0)), 0.0)


def _sphere_test_soa(o: V3, d: V3, c: V3, radius, eps):
    """line_intersects_sphere (object.c:306-321) on component tensors.
    Returns (t, hit): near positive root preferred, else far root; both
    must clear the sphere's epsilon."""
    rel = o - c
    b = -(v3m.dot(d, rel))
    cc = v3m.magsqr(rel) - radius * radius
    det = b * b - cc
    sq = _safe_sqrt(det)
    t_near = b - sq
    t = torch.where(t_near > eps, t_near, b + sq)
    hit = (det >= 0) & (t > eps)
    return t, hit


def _plane_test_soa(o: V3, d: V3, n: V3, dist, eps):
    """plane_get_intersection (object.c:473-488).  Returns (t, hit, a)
    where the sign of ``a = d·n`` decides the normal flip."""
    a = v3m.dot(d, n)
    parallel = torch.abs(a) < eps
    t = (dist - v3m.dot(o, n)) / torch.where(parallel, 1.0, a)
    hit = ~parallel & (t > eps)
    return t, hit, a


def _mt_test_soa(o: V3, d: V3, v0: V3, e1: V3, e2: V3, eps):
    """Möller-Trumbore (object.c:422-441) on component tensors: |a| inside
    the open eps interval rejects as parallel, u in [0, 1], v >= 0,
    u + v <= 1, t > eps."""
    h = v3m.cross(d, e2)
    a = v3m.dot(e1, h)
    parallel = (a < eps) & (a > -eps)
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o - v0
    u = f * v3m.dot(s, h)
    q = v3m.cross(s, e1)
    v = f * v3m.dot(d, q)
    t = f * v3m.dot(e2, q)
    hit = (~parallel & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
           & (t > eps))
    return t, hit


def _tri_chunks_soa(ds: DeviceScene, static, chunk: int):
    """Triangle tables cut into (nchunks, C) components.  Returns (comp,
    eps (nchunks, C), mat (nchunks, C) int64, valid (nchunks, C) bool,
    nchunks, C); padding rows get epsilon 1, which makes Möller-Trumbore's
    parallel test reject them."""
    nt = ds.tri_v0.shape[0]
    dev = ds.tri_v0.device
    C = min(chunk, max(8, -(-nt // 8) * 8))
    nchunks = -(-nt // C)
    pad = nchunks * C - nt

    def p(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
        return x

    comp = {}
    for name, arr in (("v0", ds.tri_v0), ("e1", ds.tri_e1),
                      ("e2", ds.tri_e2), ("n", ds.tri_n)):
        a = p(arr, 0.0)
        comp[name] = V3(a[:, 0].reshape(nchunks, C),
                        a[:, 1].reshape(nchunks, C),
                        a[:, 2].reshape(nchunks, C))
    eps = p(ds.tri_eps, 1.0).reshape(nchunks, C)
    ns = static.n_spheres
    mat = p(ds.mat_idx[ns:ns + nt], 0).reshape(nchunks, C)
    valid = p(torch.ones(nt, dtype=torch.bool, device=dev),
              False).reshape(nchunks, C)
    return comp, eps, mat, valid, nchunks, C


def closest_hit_soa(ds: DeviceScene, static, o: V3, d: V3, *,
                    tri_chunk: int = 512, include_triangles: bool = True):
    """Closest intersection over all primitives.

    o, d: V3 of (P,).  Returns (t, gid, mat, normal V3); t = FLT_MAX and
    gid = -1 (mat = 0) on a miss.  ``include_triangles=False`` folds the
    spheres and planes only (the pre-pass of the cluster sweep)."""
    shape, dev = o.x.shape, o.x.device
    bt = torch.full(shape, FLT_MAX, dtype=torch.float32, device=dev)
    bg = torch.full(shape, -1, dtype=torch.int64, device=dev)
    bm = torch.zeros(shape, dtype=torch.int64, device=dev)
    bn = v3m.full(shape, 0.0, device=dev)
    ns, nt, npl = static.n_spheres, static.n_triangles, static.n_planes

    for i in range(npl):
        n = v3m.splat(ds.pln_n[i])
        t, hit, a = _plane_test_soa(o, d, n, ds.pln_d[i], ds.pln_eps[i])
        t = torch.where(hit, t, FLT_MAX)
        better = t < bt
        sgn = torch.where(torch.signbit(a), 1.0, -1.0)  # flip on back side
        bt = torch.where(better, t, bt)
        bg = torch.where(better, ns + nt + i, bg)
        bm = torch.where(better, static.material_index[ns + nt + i], bm)
        bn = v3m.where(better, n * sgn, bn)

    for i in range(ns):
        c = v3m.splat(ds.sph_center[i])
        r = ds.sph_radius[i]
        t, hit = _sphere_test_soa(o, d, c, r, ds.sph_eps[i])
        t = torch.where(hit, t, FLT_MAX)
        better = t < bt
        # outward normal at the hit point (object.c:258-261)
        tn = torch.where(t < FLT_MAX, t, 1.0)
        nrm = (o + d * tn - c) * (1.0 / r)
        bt = torch.where(better, t, bt)
        bg = torch.where(better, i, bg)
        bm = torch.where(better, static.material_index[i], bm)
        bn = v3m.where(better, nrm, bn)

    if nt and include_triangles:
        comp, eps_c, mat_c, _, nchunks, C = _tri_chunks_soa(ds, static,
                                                            tri_chunk)
        iota = torch.arange(C, device=dev)[:, None]
        ob, db = o.map(lambda a: a[None]), d.map(lambda a: a[None])
        for k in range(nchunks):
            def col(v: V3):
                return v.map(lambda a: a[k][:, None])
            t, hit = _mt_test_soa(ob, db, col(comp["v0"]), col(comp["e1"]),
                                  col(comp["e2"]), eps_c[k][:, None])
            t = torch.where(hit, t, FLT_MAX)                    # (C, P)
            tmin = t.amin(0)
            # the first winner of the chunk (ties go to the lowest lane)
            win = (t == tmin[None]) & (t < FLT_MAX)
            first = torch.where(win, iota, C).amin(0).clamp(max=C - 1)
            better = tmin < bt
            nrm = comp["n"].map(lambda a: a[k][first])
            bt = torch.where(better, tmin, bt)
            bg = torch.where(better, first + (k * C + ns), bg)
            bm = torch.where(better, mat_c[k][first], bm)
            bn = v3m.where(better, nrm, bn)

    return bt, bg, bm, bn


def tint_slots(static) -> tuple:
    """The transparent materials' ids, in slot order."""
    return tuple(m for m, tr in enumerate(static.is_transparent) if tr)


def tint_from_counts(kt, slots: tuple, counts) -> V3:
    """The tint Π_m kt[slots[m]]^counts[..., m] of a shadow segment, from
    its count of blockers per transparent slot; differentiable into the
    (M, 3) table ``kt``.  ``pow`` of a zero count is 1 with a zero
    gradient, whatever the base."""
    comps = []
    for c in range(3):
        t = None
        for m, mat in enumerate(slots):
            f = torch.pow(kt[mat, c], counts[..., m].to(kt.dtype))
            t = f if t is None else t * f
        comps.append(t)
    return V3(*comps)


def slot_counts(mask, slot, n_slots: int, dim: int):
    """Per transparent slot, the count of ``mask`` lanes of that slot over
    axis ``dim``, stacked on a new trailing axis (int16)."""
    return torch.stack([(mask & (slot == m)).sum(dim, dtype=torch.int16)
                        for m in range(n_slots)], -1)


def any_hit_counts_soa(ds: DeviceScene, static, o: V3, d: V3, max_dist,
                       exclude_gid, *, tri_chunk: int = 512,
                       include_triangles: bool = True):
    """Shadow query (is_light_blocked, render.c:126-134).

    Opaque hits at t < max_dist block; a transparent hit adds one to its
    material's slot count (accel.c:369-374 multiplies the tint by its kt).
    Ray components may have any shape (a (lc, P) batch of samples against
    (P,) origins broadcasts).  Returns (blocked, counts (..., n_slots)
    int16, or None for a scene without a transparent material) of the
    rays' shape."""
    shape = torch.broadcast_shapes(o.x.shape, d.x.shape)
    dev = d.x.device
    blocked = torch.zeros(shape, dtype=torch.bool, device=dev)
    slots = tint_slots(static)
    counts = (torch.zeros(shape + (len(slots),), dtype=torch.int16,
                          device=dev) if slots else None)
    ns, nt, npl = static.n_spheres, static.n_triangles, static.n_planes

    def fold_one(t, hit, gid, mi):
        nonlocal blocked
        in_range = hit & (t < max_dist) & (exclude_gid != gid)
        if static.is_transparent[mi]:
            counts[..., slots.index(mi)] += in_range
        else:
            blocked = blocked | in_range

    for i in range(npl):
        n = v3m.splat(ds.pln_n[i])
        t, hit, _ = _plane_test_soa(o, d, n, ds.pln_d[i], ds.pln_eps[i])
        fold_one(t, hit, ns + nt + i, static.material_index[ns + nt + i])

    for i in range(ns):
        c = v3m.splat(ds.sph_center[i])
        t, hit = _sphere_test_soa(o, d, c, ds.sph_radius[i], ds.sph_eps[i])
        fold_one(t, hit, i, static.material_index[i])

    if nt and include_triangles:
        comp, eps_c, mat_c, valid, nchunks, C = _tri_chunks_soa(
            ds, static, tri_chunk)
        transp_tab = torch.as_tensor(static.is_transparent, device=dev)
        transp_all = transp_tab[mat_c] & valid                  # (nchunks, C)
        any_transp = bool(np.asarray(static.is_transparent, bool)[
            np.asarray(static.material_index[ns:ns + nt], np.int64)].any())
        if any_transp:
            slot_all = torch.as_tensor(                         # (nchunks, C)
                [slots.index(m) if tr else -1
                 for m, tr in enumerate(static.is_transparent)],
                device=dev)[mat_c]
        # the chunk axis C leads; the rays' axes follow
        cdim = (C,) + (1,) * len(shape)
        iota = torch.arange(C, device=dev).reshape(cdim)

        def ex(a):
            return a.reshape(cdim)

        ob, db = o.map(lambda a: a[None]), d.map(lambda a: a[None])
        md, exg = max_dist[None], torch.as_tensor(exclude_gid, device=dev)
        for k in range(nchunks):
            t, hit = _mt_test_soa(
                ob, db, comp["v0"].map(lambda a: ex(a[k])),
                comp["e1"].map(lambda a: ex(a[k])),
                comp["e2"].map(lambda a: ex(a[k])), ex(eps_c[k]))
            gid = iota + (k * C + ns)
            in_range = hit & (t < md) & (exg[None] != gid)
            if not any_transp:
                # no transparent triangle: one any-reduce, no material data
                blocked = blocked | in_range.any(0)
                continue
            tr_k = ex(transp_all[k])
            blocked = blocked | (in_range & ~tr_k).any(0)
            counts = counts + slot_counts(in_range & tr_k, ex(slot_all[k]),
                                          len(slots), 0)

    return blocked, counts


def intersect_prim_soa(ds: DeviceScene, o: V3, d: V3, gid):
    """Re-test one primitive per ray (render.c:143-144, rays inside an
    object): primitive ``gid`` (P,), or a miss where gid is -1.  The
    per-ray parameters are gathered; the arithmetic is the JAX package's
    ``intersect_prim`` (sphere normal by division, the plane's flipped to
    face the ray).  Returns (t, hit, normal V3)."""
    ns = ds.sph_center.shape[0]
    nt = ds.tri_v0.shape[0]
    npl = ds.pln_n.shape[0]
    g = torch.clamp(gid, min=0)
    zero_t = torch.zeros(o.x.shape, dtype=torch.float32, device=o.x.device)
    zero_h = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    zero_n = V3(zero_t, zero_t, zero_t)

    if ns:
        si = torch.clamp(g, 0, ns - 1)
        center = v3m.rows(ds.sph_center, si)
        radius = ds.sph_radius[si]
        rel = o - center
        b = -v3m.dot(d, rel)
        c = v3m.magsqr(rel) - radius * radius
        det = b * b - c
        sq = _safe_sqrt(det)
        t_near = b - sq
        st = torch.where(t_near > ds.sph_eps[si], t_near, b + sq)
        sh = (det >= 0) & (st > ds.sph_eps[si])
        sn = (o + d * st - center).map(lambda a: a / radius)
    else:
        st, sh, sn = zero_t, zero_h, zero_n

    if nt:
        ti = torch.clamp(g - ns, 0, nt - 1)
        v0, e1, e2 = (v3m.rows(x, ti) for x in (ds.tri_v0, ds.tri_e1,
                                                 ds.tri_e2))
        tt, th = _mt_test_soa(o, d, v0, e1, e2, ds.tri_eps[ti])
        tn = v3m.rows(ds.tri_n, ti)
    else:
        tt, th, tn = zero_t, zero_h, zero_n

    if npl:
        pi = torch.clamp(g - ns - nt, 0, npl - 1)
        n = v3m.rows(ds.pln_n, pi)
        pt, ph, a = _plane_test_soa(o, d, n, ds.pln_d[pi], ds.pln_eps[pi])
        pn = v3m.where(torch.signbit(a), n, -n)
    else:
        pt, ph, pn = zero_t, zero_h, zero_n

    is_s = gid < ns
    is_t = (gid >= ns) & (gid < ns + nt)
    t = torch.where(is_s, st, torch.where(is_t, tt, pt))
    hit = (gid >= 0) & torch.where(is_s, sh, torch.where(is_t, th, ph))
    n = v3m.where(is_s, sn, v3m.where(is_t, tn, pn))
    return t, hit, n

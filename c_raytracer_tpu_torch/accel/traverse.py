"""Cluster traversal for mesh scenes, as in ``c_raytracer_tpu.accel.traverse``.

The reference walks a binary LBVH per ray (accel.c:322-387).  The cluster
structure replaces the tree: Morton-ordered triangles grouped into fixed
blocks of C (build.py), each with an AABB re-fit from the vertices every
frame.  Per batch of rays:

1. the visit order (kernel 3, ``pallas_visit.visit_order``): the slab test
   of every ray against every cluster AABB and each ray's V nearest
   overlapped clusters, with the count of overlaps beyond V (``spill``);
2. a loop over the V visit slots: gather each ray's cluster block and run
   Möller-Trumbore on its C lanes, folding the running best hit (closest)
   or the blocked / kt-tint accumulators (shadows).

Soft shadows of opaque scenes go through the shared-origin sweep instead:
one conservative visit list per pixel (``shadow_visit_order``), a
per-pixel shortlist of candidate triangles (``shadow_shortlist``), and
every light sample streamed against that shortlist
(``any_hit_tint_shortlist``), or against the visited blocks when the
shortlist is off (``any_hit_tint_shared``, whose visit loop is kernel 4,
``union_sweep.union_visits``).

Each function keeps the JAX function's semantics and fold order.  Every
selection the JAX package makes with ``lax.top_k`` or with its iterative
min-and-first-index extraction is a stable sort here: the same ascending
order with ties to the lowest index (``torch.topk`` promises no tie
order).  The JAX ``lax.cond`` that skips dead visit steps becomes, with
``dead_skip``, one read of the batch's longest live list per sweep — not a
host sync per visit; without it every visit runs, as the JAX opaque auto
does.

Soft shadows of transparent scenes count blockers: every in-range blocker
of transparent slot ``m`` (geometry/primitives.py ``tint_slots``) adds one
to the sample's count ``m``, and every opaque one sets its ``blocked``.
The JAX package multiplies a tint by kt instead (an opaque blocker by 0);
the light's tint Π kt_m^count_m is formed from the counts where it is
shaded, so the sweeps carry no material data and their counts, saved for
the backward, give the tint's gradient without a second sweep.  The union
sweep (``shadow_union_visit_order``) lists, per pixel, every cluster that
any of its samples' segments overlaps, nearest the origin first.

Gradients: selection is cut from the graph where the JAX package stops it
(the cluster AABBs and bounding spheres, the rays of every visit order,
the shared-origin capsule and shortlist origins), while the hit distances
of ``_mt_block`` and the winner's normal gather stay differentiable, into
the gathered ``blk`` rows and from there, through ``pack_clusters``, into
the triangle vertices.  The shadow sweeps return masks and counts only;
shading runs them without autograd (render/shading.py).

The diagnostics ``spill_counts`` and ``shadow_spill_counts`` (behind
accel/validate.py) count exactly what the sweeps truncate, in pixel
chunks that keep every (pixels, boxes) temporary near 1 GiB.

Two opt-ins of the closest-hit and per-ray sweeps (``RenderConfig``
``bvh_super_group`` and ``closest_compact``): the two-level visit order
``_visit_order_super``, kernel 3 on super-cluster boxes and then the
nearest of their members, and ray compaction, the closest-hit sweep in
blocks of rays sorted by list length (``_closest_scan_compact``).  Two
faults of the JAX package's super order are not copied: a ray that enters
fewer than S supers (S ≤ 32) gets super 0's members again in every slot
after its last entered super, and the padding of a short last super
overlaps every ray at entry 0; here each entered super's real members
enter the second level once.

Primitive-range shards (geometry/sharded.py) pack a cluster set per shard
(``pack_clusters_sharded``); each runs the sweeps above on its own range.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c_raytracer_tpu_torch.accel import pallas_visit, union_sweep
from c_raytracer_tpu_torch.core import tracing
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.geometry.primitives import slot_counts, tint_slots

FLT_MAX = float(np.finfo(np.float32).max)

# packed field rows in ClusterSet.blk: v0, e1, e2, n (3 each), eps; scenes
# with transparent materials append kt (3) and a 0/1 transparency flag
_F_V0, _F_E1, _F_E2, _F_N, _F_EPS, _F_KT, _F_TRANSP = 0, 3, 6, 9, 12, 13, 16
_NF_OPAQUE = 13
_NF_TRANSP = 17


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Morton-ordered triangle clusters, packed for per-ray block gathers."""

    blk: torch.Tensor    # (K, 13|17, C) packed triangle fields
    lo: torch.Tensor     # (K, 3) cluster AABB min, inflated by eps
    hi: torch.Tensor     # (K, 3) cluster AABB max, inflated by eps
    gid0: int            # global prim id of triangle 0 (= n_spheres)
    flat: torch.Tensor   # (K·C, 13|17) the same fields, triangle-major
    bound: torch.Tensor  # (K, C, 4) per-triangle bounding sphere (centroid,
    #                      radius; padding lanes get radius -1)
    # transparent packs: each packed triangle's transparent slot, -1 for an
    # opaque or padding lane (K·C,), and the scene's number of slots
    slot: torch.Tensor | None = None
    n_slots: int = 0

    @property
    def has_transp(self) -> bool:
        """Whether the kt/transparency rows are packed."""
        return self.blk.shape[-2] == _NF_TRANSP

    def slots_of(self, gid):
        """The transparent slot of each global triangle id in ``gid``."""
        return self.slot[gid - self.gid0]


def _sum3(x):
    """Sum over a trailing axis of 3, left to right."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _pack_from_arrays(v0, e1, e2, n, eps, valid, kt, transp, C: int):
    """Pack (M, 3) triangle fields into clusters of C.  Rows where
    ``valid`` is False, and the padding to whole clusters, are dead: eps 1
    (Möller-Trumbore's parallel test rejects them) and bounding radius -1.
    Returns (blk, lo, hi, flat, bound)."""
    M = v0.shape[0]
    K = max(1, -(-M // C))
    pad = K * C - M

    def p(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
        return x

    v0, e1, e2, n = p(v0, 0.0), p(e1, 0.0), p(e2, 0.0), p(n, 0.0)
    valid = p(valid, False)
    eps = torch.where(valid, p(eps, 1.0), 1.0)

    rows = [v0, e1, e2, n, eps[:, None]]
    if kt is not None:
        tf = valid & p(transp, False)
        rows += [p(kt, 0.0), tf.to(torch.float32)[:, None]]
    flat = torch.cat(rows, dim=1)                       # (K*C, F)
    blk = flat.reshape(K, C, flat.shape[1]).transpose(1, 2).contiguous()

    # selection only, without gradient (stop_gradient in the JAX package)
    with torch.no_grad():
        # per-triangle bounding spheres for shortlist scoring
        v1, v2 = v0 + e1, v0 + e2
        cen = (v0 + v1 + v2) * float(np.float32(1.0 / 3.0))
        r2 = torch.maximum(torch.maximum(_sum3((v0 - cen) ** 2),
                                         _sum3((v1 - cen) ** 2)),
                           _sum3((v2 - cen) ** 2))
        rad = torch.where(valid, v3m.sqrt(r2) + eps, -1.0)
        bound = torch.cat([cen, rad[:, None]], -1).reshape(K, C, 4)

        # AABB refit: per-triangle min/max over its 3 vertices, padding
        # masked, reduced per cluster, inflated by the cluster's largest
        # epsilon (the reference inflates node slabs by node->epsilon,
        # accel.c:120-156)
        verts = torch.stack([v0, v1, v2], dim=1)        # (K*C, 3, 3)
        vm = valid[:, None]
        vmin = torch.where(vm, verts.amin(1), FLT_MAX).reshape(K, C, 3)
        vmax = torch.where(vm, verts.amax(1), -FLT_MAX).reshape(K, C, 3)
        ceps = torch.where(valid, eps, 0.0).reshape(K, C).amax(1)[:, None]
        lo, hi = vmin.amin(1) - ceps, vmax.amax(1) + ceps
    return blk, lo, hi, flat, bound


def pack_clusters(ds, static, cluster_size: int) -> ClusterSet:
    """Pack the device triangle tables into clusters of ``cluster_size``
    and re-fit the cluster AABBs from the current vertices."""
    ns = static.n_spheres
    nt = ds.tri_v0.shape[0]
    dev = ds.tri_v0.device
    mat_np = np.asarray(static.material_index[ns:ns + nt], np.int64)
    transp_np = np.asarray(static.is_transparent, bool)[mat_np]
    kt = transp = slot = None
    slots = tint_slots(static)
    if transp_np.any():
        tracing.count("sync.pack_clusters", 3)   # the copies from the host
        mat = torch.as_tensor(mat_np, device=dev)
        kt = ds.materials.kt[mat]                            # (nt, 3)
        transp = torch.as_tensor(transp_np, device=dev)
        slot_np = np.full(-(-nt // cluster_size) * cluster_size, -1,
                          np.int64)
        slot_np[:nt] = [slots.index(m) if t else -1
                        for m, t in zip(mat_np.tolist(), transp_np)]
        slot = torch.as_tensor(slot_np, device=dev)
    blk, lo, hi, flat, bound = _pack_from_arrays(
        ds.tri_v0, ds.tri_e1, ds.tri_e2, ds.tri_n, ds.tri_eps,
        torch.ones(nt, dtype=torch.bool, device=dev), kt, transp,
        cluster_size)
    return ClusterSet(blk=blk, lo=lo, hi=hi, gid0=ns, flat=flat, bound=bound,
                      slot=slot, n_slots=len(slots))


def pack_clusters_sharded(sh, static, cluster_size: int) -> tuple:
    """One ClusterSet per local shard of ``sh`` (geometry/sharded.py
    ``TriShards``), each packed from its own contiguous Morton range (any
    contiguous slice of a Morton order is spatially tight), so that each
    shard runs the same sorted cluster sweep.  Ids stay global: shard s
    covers ids ns + s·m onwards, its ``gid0``.

    Only a shard's triangles are packed, not the pad rows after the last
    one: a cluster of pad rows only would have an inverted box (lo =
    FLT_MAX > hi), and the slab test overlaps an inverted box at entry 0
    on every ray, so such clusters would take the first visit slots of
    every ray (the JAX package packs them).  A shard without a triangle
    gets None."""
    slots = tint_slots(static)
    out = []
    for k in range(sh.n_local):
        n = min(max(static.n_triangles - sh.rows(k).start, 0), sh.m)
        if not n:
            out.append(None)
            continue

        def rows(v):
            return torch.stack([v.x[k, :n], v.y[k, :n], v.z[k, :n]], -1)
        valid = sh.gid[k, :n] >= 0
        kt = transp = slot = None
        if sh.kt is not None:
            # two reads of the shard's tables and a copy back
            tracing.count("sync.pack_clusters", 3)
            kt, transp = sh.kt[k, :n], sh.transp[k, :n]
            mat_np = sh.mat[k, :n].cpu().numpy()
            tr_np = transp.cpu().numpy()
            slot_np = np.full(-(-n // cluster_size) * cluster_size, -1,
                              np.int64)
            slot_np[:n] = [slots.index(m) if t else -1
                           for m, t in zip(mat_np.tolist(), tr_np)]
            slot = torch.as_tensor(slot_np, device=valid.device)
        blk, lo, hi, flat, bound = _pack_from_arrays(
            rows(sh.v0), rows(sh.e1), rows(sh.e2), rows(sh.n),
            sh.eps[k, :n], valid, kt, transp, cluster_size)
        out.append(ClusterSet(
            blk=blk, lo=lo, hi=hi,
            gid0=static.n_spheres + sh.rows(k).start, flat=flat,
            bound=bound, slot=slot, n_slots=len(slots)))
    return tuple(out)


def _k_smallest_payload(key, payload, V):
    """The V smallest per row of ``key`` (R, K), ascending, ties to the
    lowest index, with the int ``payload`` of each picked entry: (vals,
    payloads), each (R, V).  The JAX package extracts by V passes of
    min + first index + mask; a stable sort gives the same entries wherever
    the value is below FLT_MAX (its callers mask the rest)."""
    vals, pos = torch.sort(key, dim=1, stable=True)
    pos = pos[:, :V]
    return vals[:, :V], torch.gather(payload, 1, pos)


def _visit_order(cs: ClusterSet, o, d, visits: int, count_max_dist=None):
    """The slab test of every ray against every cluster, sorted by entry
    distance: (cids (R, V) int64, ok (R, V), entry (R, V), spill (R,)).

    ``spill`` counts each ray's overlapping clusters beyond the budget V
    (spill == 0 proves the sweep saw every overlapped cluster); with
    ``count_max_dist`` (R,) only clusters entered before that distance
    count.  Kernel 3 on the card, its plain version on the CPU
    (accel/pallas_visit.py): both give the same lists and the exact
    spill."""
    K = cs.lo.shape[0]
    V = max(1, min(visits, K))   # visits=0 would make the sweep empty
    # selection only: kernel 3 and its plain version never build a graph
    cmd = None if count_max_dist is None else count_max_dist.detach()
    cids, entry, spill = pallas_visit.visit_order(
        o.detach().contiguous(), d.detach().contiguous(), cs.lo.detach(),
        cs.hi.detach(), V, None if cmd is None else cmd.contiguous())
    return cids.long(), entry < FLT_MAX, entry, spill


def _slab(lo, hi, o, inv):
    """The slab test of rays o (R, 3), ``inv`` their inverse directions,
    against one box per (ray, candidate): lo, hi lists of three (R, M)
    per-axis tensors.  Returns (entry, overlap), each (R, M)."""
    tmin = tmax = None
    for c in range(3):
        t1 = (lo[c] - o[:, c, None]) * inv[:, c, None]
        t2 = (hi[c] - o[:, c, None]) * inv[:, c, None]
        a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = a if tmin is None else torch.maximum(tmin, a)
        tmax = b if tmax is None else torch.minimum(tmax, b)
    entry = torch.clamp(tmin, min=0.0)
    return entry, tmax >= entry


@torch.no_grad()
def _visit_order_super(cs: ClusterSet, o, d, visits: int, G: int, S: int,
                       count_max_dist=None):
    """Two-level visit order: (cids (R, V), ok (R, V), entry (R, V),
    spill (R,)) as ``_visit_order`` returns them.

    Level 1 runs kernel 3 on the Ks = ceil(K/G) super boxes (the bounds of
    each run of G consecutive Morton clusters; a short last run is padded
    with boxes that bound nothing) and keeps each ray's nearest S' =
    min(S, Ks) entered supers, by (entry, id), with their spill counted
    under ``count_max_dist``.  Level 2 slab-tests the S'·G members of
    those supers and keeps the nearest V = min(visits, K, S·G) by entry,
    ties to the lowest candidate position: the nearer super's member
    first.  A slot that kernel 3 left empty, and a padding member, gives
    no candidate.  ``spill`` is the members' count beyond V plus G times
    the supers' beyond S' (a bound: every truncation shows).  Selection
    only: no gradient."""
    K = cs.lo.shape[0]
    V = max(1, min(visits, K, S * G))
    Ks = -(-K // G)
    pad = Ks * G - K
    lo, hi = cs.lo, cs.hi
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, 3), FLT_MAX)])
        hi = torch.cat([hi, hi.new_full((pad, 3), -FLT_MAX)])
    # contiguous, so 16-byte aligned, as kernel 3 takes its boxes
    slo = lo.reshape(Ks, G, 3).amin(1).contiguous()
    shi = hi.reshape(Ks, G, 3).amax(1).contiguous()
    o, d = o.contiguous(), d.contiguous()
    cmd = None if count_max_dist is None else count_max_dist.contiguous()
    S1 = min(S, Ks)
    scids, sentry, s_spill = pallas_visit.visit_order(o, d, slo, shi, S1,
                                                      cmd)
    slot_ok = sentry < FLT_MAX                             # (R, S1)

    R = o.shape[0]
    members = torch.arange(G, device=o.device)
    cand = (scids.long().clamp(0, Ks - 1)[:, :, None] * G
            + members).reshape(R, S1 * G)                  # (R, S1·G)
    live = (slot_ok[:, :, None].expand(R, S1, G).reshape(R, S1 * G)
            & (cand < K))
    dd = torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    inv = 1.0 / dd
    entry, ov = _slab([lo[:, c][cand] for c in range(3)],
                      [hi[:, c][cand] for c in range(3)], o, inv)
    ov = ov & live
    counted = ov if cmd is None else ov & (entry < cmd[:, None])
    spill = (torch.clamp(counted.sum(-1) - V, min=0)
             + G * s_spill.long()).to(torch.int32)
    # S1·G >= V: S1 = S, or S1 = Ks and Ks·G >= K >= V
    vals, cids = _k_smallest_payload(torch.where(ov, entry, FLT_MAX), cand,
                                     V)
    ok = vals < FLT_MAX
    return torch.where(ok, cids, 0), ok, vals, spill


def _visit_limit(ok, dead_skip: bool) -> int:
    """Visit slots to run: all of them, or with ``dead_skip`` the batch's
    longest live list (lists are front-packed; one host read per sweep,
    counted as ``sync.visit_limit``)."""
    if not dead_skip or ok.shape[0] == 0:
        return ok.shape[1]
    tracing.count("sync.visit_limit")
    return int(ok.sum(1).max())


_CHUNK_ELEMS = 2 ** 28  # entries of one (rows, columns) float32 temporary


def _row_chunks(n_rows: int, n_cols: int):
    """Slices of at most ``_CHUNK_ELEMS // n_cols`` rows covering n_rows."""
    step = max(1, _CHUNK_ELEMS // max(1, n_cols))
    return [slice(i, min(i + step, n_rows)) for i in range(0, n_rows, step)]


@torch.no_grad()
def spill_counts(cs: ClusterSet, o, d, visits: int):
    """Diagnostic: per-ray count of slab-overlapping clusters and how many
    exceeded the visit budget (the closest-hit sweep's truncation), as
    (n (R,), spill (R,)) int32.

    The closest sweep prunes sorted visits by best-so-far t, so spill > 0
    does NOT always mean a wrong hit — but spill == 0 *proves* the sweep
    was exhaustive.  Used by accel/validate.py's spill policy."""
    K = cs.lo.shape[0]
    V = min(visits, K)
    dd = torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    inv = 1.0 / dd
    n = []
    for rows in _row_chunks(o.shape[0], K):
        oc, ic = o[rows], inv[rows]
        tmin = tmax = None
        # one axis at a time; max and min are exact in any order
        for c in range(3):
            t1 = (cs.lo[None, :, c] - oc[:, c, None]) * ic[:, c, None]
            t2 = (cs.hi[None, :, c] - oc[:, c, None]) * ic[:, c, None]
            lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tmin = lo_t if tmin is None else torch.maximum(tmin, lo_t)
            tmax = hi_t if tmax is None else torch.minimum(tmax, hi_t)
        overlap = tmax >= torch.clamp(tmin, min=0.0)
        n.append(overlap.sum(-1, dtype=torch.int32))
    n = torch.cat(n)
    return n, torch.clamp(n - V, min=0)


@torch.no_grad()
def shadow_spill_counts(cs: ClusterSet, origin, hull_lo, hull_hi,
                        visits: int, k_short: int):
    """Diagnostic: per-pixel spill of the shared-origin shadow sweep.

    Returns (cluster_spill, tri_spill), int32 (P,): capsule-overlapping
    clusters beyond the visit budget, and capsule-overlapping *triangles*
    beyond the shortlist K (0 when the shortlist is disabled).  Unlike
    closest hits, the shadow tint product needs EVERY transparent blocker
    along the segment, so any spill on a transparent scene can lose kt
    factors.  The capsule dot products are elementwise products summed
    left to right (the JAX package's cluster test is an ``einsum``), so
    the card and the CPU round them alike."""
    K = cs.lo.shape[0]
    V = min(visits, K)
    center = 0.5 * (cs.lo + cs.hi)                          # (K, 3)
    half_diag = 0.5 * _norm3(cs.hi - cs.lo)                 # (K,)
    ecenter = 0.5 * (hull_lo + hull_hi)
    erad = 0.5 * _norm3(hull_hi - hull_lo)
    C = cs.bound.shape[1]
    b = cs.bound.reshape(K * C, 4)
    cen, rad = b[:, :3], b[:, 3]
    cl_spill, tri_spill = [], []
    for rows in _row_chunks(origin.shape[0], K * C if k_short else K):
        org = origin[rows].detach()
        seg = ecenter[None] - org                           # (p, 3)
        seglen2 = torch.clamp(_sum3(seg * seg), min=1e-30)
        rel = [center[None, :, c] - org[:, c, None] for c in range(3)]
        s = torch.clamp((rel[0] * seg[:, 0, None] + rel[1] * seg[:, 1, None]
                         + rel[2] * seg[:, 2, None]) / seglen2[:, None],
                        0.0, 1.0)
        d2 = 0.0
        for c in range(3):
            r = rel[c] - s * seg[:, c, None]
            d2 = d2 + r * r
        margin = half_diag[None] + s * erad
        n_cl = (d2 <= margin * margin).sum(-1, dtype=torch.int32)
        cl_spill.append(torch.clamp(n_cl - V, min=0))
        if not k_short:
            continue
        # triangle-level: the capsule test of shadow_shortlist over ALL
        # triangles' bounding spheres (the true candidate count the
        # shortlist competes for)
        seglen = v3m.sqrt(seglen2)
        rx = cen[None, :, 0] - org[:, 0, None]
        ry = cen[None, :, 1] - org[:, 1, None]
        rz = cen[None, :, 2] - org[:, 2, None]
        dot = (rx * seg[:, 0, None] + ry * seg[:, 1, None]
               + rz * seg[:, 2, None])
        st = torch.clamp(dot / seglen2[:, None], 0.0, 1.0)
        cx = rx - st * seg[:, 0, None]
        cy = ry - st * seg[:, 1, None]
        cz = rz - st * seg[:, 2, None]
        td2 = cx * cx + cy * cy + cz * cz
        s_hi = torch.clamp((dot + rad[None] * seglen[:, None])
                           / seglen2[:, None], 0.0, 1.0)
        tmargin = rad[None] + s_hi * erad
        t_overlap = (td2 <= tmargin * tmargin) & (rad[None] >= 0)
        n_tri = t_overlap.sum(-1, dtype=torch.int32)
        tri_spill.append(torch.clamp(n_tri - min(k_short, V * C), min=0))
    cl_spill = torch.cat(cl_spill)
    if not k_short:
        return cl_spill, torch.zeros_like(cl_spill)
    return cl_spill, torch.cat(tri_spill)


def _mt_block(blk, o, d):
    """Möller-Trumbore on a gathered block: blk (R, F, C), o/d (R, 3).
    Exact accept rules of object.c:422-441.  Returns (t, hit) each (R, C)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = blk[:, _F_V0], blk[:, _F_V0 + 1], blk[:, _F_V0 + 2]
    e1x, e1y, e1z = blk[:, _F_E1], blk[:, _F_E1 + 1], blk[:, _F_E1 + 2]
    e2x, e2y, e2z = blk[:, _F_E2], blk[:, _F_E2 + 1], blk[:, _F_E2 + 2]
    eps = blk[:, _F_EPS]

    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = (a < eps) & (a > -eps)
    f = 1.0 / torch.where(parallel, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = (~parallel & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
           & (t > eps))
    return t, hit


def _first_min(t):
    """(min, index of its first occurrence) over the last axis."""
    tmin = t.amin(-1)
    iota = torch.arange(t.shape[-1], device=t.device)
    first = torch.where(t == tmin[..., None], iota, t.shape[-1]).amin(-1)
    return tmin, first.clamp(max=t.shape[-1] - 1)


def _closest_scan(cs, cids, ok, entry, o, d, bt0, bg0, dead_skip: bool):
    """The visit loop of ``closest_hit_clusters``: fold each ray's sorted
    visit list into (best_t, best_gid)."""
    C = cs.blk.shape[2]
    bt, bg = bt0, bg0
    for v in range(_visit_limit(ok, dead_skip)):
        cid = cids[:, v]
        # a cluster entered beyond the running best cannot beat it: sorted
        # entries make every later visit farther (accel.c:341-352 pruning)
        live = ok[:, v] & (entry[:, v] < bt)
        t, hit = _mt_block(cs.blk[cid], o, d)
        t = torch.where(hit & live[:, None], t, FLT_MAX)
        tmin, lane = _first_min(t)
        better = tmin < bt
        bt = torch.where(better, tmin, bt)
        bg = torch.where(better, cs.gid0 + cid * C + lane, bg)
    return bt, bg


def _closest_scan_compact(cs, cids, ok, entry, o, d, bt0, bg0, block: int):
    """``_closest_scan`` with ray compaction: the rays sorted by live list
    length (a stable sort), folded in blocks of ``block`` sorted rays that
    each stop at their own longest list, and put back in order.  Each ray
    folds its own list in the same order, so (best_t, best_gid) are bit
    for bit the uncompacted sweep's; the permutation carries no gradient,
    the gathers of o, d and the running best do."""
    order = torch.argsort(ok.sum(1), stable=True)
    bt, bg = [], []
    for b0 in range(0, o.shape[0], block):
        r = order[b0:b0 + block]
        t_b, g_b = _closest_scan(cs, cids[r], ok[r], entry[r], o[r], d[r],
                                 bt0[r], bg0[r], dead_skip=True)
        bt.append(t_b)
        bg.append(g_b)
    inv = torch.argsort(order)
    return torch.cat(bt)[inv], torch.cat(bg)[inv]


def closest_hit_clusters(cs: ClusterSet, o, d, best, *, visits: int,
                         dead_skip: bool = False, with_spill: bool = False,
                         super_group: int = 0, super_sel: int = 16,
                         compact_block: int = 0):
    """Fold the nearest ``visits`` clusters' triangles into ``best``.

    o, d: (R, 3); best: (t (R,), gid (R,), normal (R, 3)) from the
    sphere/plane pre-pass.  Returns the updated best; with ``with_spill``
    also the per-ray (R,) count of overlapped clusters beyond the budget
    (spill == 0 proves the sweep exhaustive; best-t pruning usually masks
    spill > 0).  The loop carries (t, gid) only; the winner's normal is
    gathered once after it.  ``super_group`` G > 0 takes the visit order
    from ``_visit_order_super`` with ``super_sel`` supers; a
    ``compact_block`` that splits R into two or more blocks folds through
    ``_closest_scan_compact``."""
    C = cs.blk.shape[2]
    if super_group:
        cids, ok, entry, spill = _visit_order_super(cs, o, d, visits,
                                                    super_group, super_sel)
    else:
        cids, ok, entry, spill = _visit_order(cs, o, d, visits)
    bt0, bg0, bn0 = best
    R = o.shape[0]
    if compact_block and R % compact_block == 0 and R // compact_block >= 2:
        bt, bg = _closest_scan_compact(cs, cids, ok, entry, o, d, bt0, bg0,
                                       compact_block)
    else:
        bt, bg = _closest_scan(cs, cids, ok, entry, o, d, bt0, bg0,
                               dead_skip)
    won = bg != bg0                        # a triangle beat the pre-pass
    ti = torch.clamp(bg - cs.gid0, 0, cs.blk.shape[0] * C - 1)
    nrm = cs.blk[ti // C, _F_N:_F_N + 3, ti % C]
    bn = torch.where(won[:, None], nrm, bn0)
    if with_spill:
        return bt, bg, bn, spill
    return bt, bg, bn


def any_hit_tint_clusters(cs: ClusterSet, o, d, max_dist, exclude_gid, acc,
                          *, visits: int, dead_skip: bool = False,
                          with_spill: bool = False, super_group: int = 0,
                          super_sel: int = 16):
    """Fold cluster triangles into the shadow accumulators — the per_ray
    shadow mode.  ``acc`` is blocked (R,) for a pack without transparent
    triangles, else (blocked (R,), counts (R, n_slots) int16): an in-range
    opaque blocker sets blocked, a transparent one adds to its slot's count
    (the JAX package multiplies a tint by kt or 0, accel.c:360-387).
    Visits are nearest first, so opaque blocking is found even past the
    budget.  ``with_spill``: also the per-ray count of in-range
    (entry < max_dist) overlapped clusters beyond the budget.
    ``super_group`` as in closest_hit_clusters."""
    C = cs.blk.shape[2]
    cmd = max_dist if with_spill else None
    if super_group:
        cids, ok, entry, spill = _visit_order_super(
            cs, o, d, visits, super_group, super_sel, count_max_dist=cmd)
    else:
        cids, ok, entry, spill = _visit_order(cs, o, d, visits,
                                              count_max_dist=cmd)
    lanes = torch.arange(C, device=o.device)
    for v in range(_visit_limit(ok, dead_skip)):
        cid = cids[:, v]
        live = ok[:, v] & (entry[:, v] < max_dist)
        blk = cs.blk[cid]
        t, hit = _mt_block(blk, o, d)
        gid = cs.gid0 + cid[:, None] * C + lanes
        in_range = (hit & live[:, None] & (t < max_dist[:, None])
                    & (gid != exclude_gid[:, None]))
        acc = _fold_blockers(cs, acc, in_range, blk, gid, -1)
    if with_spill:
        return acc, spill
    return acc


def _fold_blockers(cs: ClusterSet, acc, in_range, blk, gid, dim):
    """One visit's in-range lanes (axis ``dim`` of ``in_range``) folded
    into ``acc``: blocked, or (blocked, counts) for a transparent pack.
    ``blk`` holds the lanes' packed rows (F on axis 1, the lanes last) and
    ``gid`` their global ids, both broadcasting against ``in_range``."""
    if not cs.has_transp:
        return acc | in_range.any(dim)
    blocked, counts = acc
    transp = blk[:, _F_TRANSP] > 0
    if in_range.dim() > transp.dim():
        transp = transp[:, None]
    blocked = blocked | (in_range & ~transp).any(dim)
    counts = counts + slot_counts(in_range & transp, cs.slots_of(gid),
                                  cs.n_slots, dim)
    return blocked, counts


def _norm3(x):
    """Euclidean norm over a trailing axis of 3."""
    return v3m.sqrt(_sum3(x * x))


def shadow_visit_order(cs: ClusterSet, origin, hull_lo, hull_hi,
                       visits: int):
    """Visit list for a shared-origin shadow query.

    All of a pixel's soft-shadow rays start at its hit point and end on
    the emitter, so one conservative list per pixel serves every sample: a
    cluster is a candidate iff its bounding sphere comes within s·erad of
    the origin→emitter-centre chord at fraction s (a capsule test), nearest
    first by distance from the origin.  Returns (cids (P, V), ok (P, V))."""
    origin = origin.detach()
    K = cs.lo.shape[0]
    V = max(1, min(visits, K))
    center = 0.5 * (cs.lo + cs.hi)                          # (K, 3)
    half_diag = 0.5 * _norm3(cs.hi - cs.lo)                 # (K,)
    ecenter = 0.5 * (hull_lo + hull_hi)
    erad = 0.5 * _norm3(hull_hi - hull_lo)
    seg = ecenter[None] - origin                            # (P, 3)
    seglen2 = torch.clamp(_sum3(seg * seg), min=1e-30)
    rel = [center[None, :, c] - origin[:, c, None] for c in range(3)]
    s = torch.clamp((rel[0] * seg[:, 0, None] + rel[1] * seg[:, 1, None]
                     + rel[2] * seg[:, 2, None]) / seglen2[:, None], 0.0, 1.0)
    # one (P, K) residual at a time (three at once would add two (P, K)
    # temporaries to the frame's peak memory); 0 + x is exact
    d2 = sum_sq = 0.0
    for c in range(3):
        r = rel[c] - s * seg[:, c, None]
        d2 = d2 + r * r
        sum_sq = sum_sq + rel[c] * rel[c]
    margin = half_diag[None] + s * erad
    key = torch.where(d2 <= margin * margin, sum_sq, FLT_MAX)
    vals, idx = torch.sort(key, dim=1, stable=True)
    return idx[:, :V], vals[:, :V] < FLT_MAX


def _k_smallest(key, V: int):
    """(vals, idx) of the V smallest entries per row of ``key`` (R, K),
    ascending, ties to the lowest index: both branches of the JAX
    package's ``_k_smallest`` (``lax.top_k`` above V = 32, V passes of
    min + first index below) give this order wherever the value is below
    FLT_MAX, and so does a stable sort (callers mask the rest)."""
    vals, idx = torch.sort(key, dim=1, stable=True)
    return vals[:, :V], idx[:, :V]


def shadow_union_visit_order(cs: ClusterSet, origin, dirs_fn, nchunks,
                             visits: int, live=None):
    """Exact per-pixel visit list of a shared-origin shadow query: the
    union over every sample's segment of the clusters its slab test
    overlaps before the segment's end (the per-ray sweep's test,
    accel.c:111-158), nearest the origin first by squared centre distance.

    origin (P, 3); dirs_fn(chunk_i) -> (d (P, lc, 3), max_dist (P, lc), _).
    Samples are tested in groups of ``su = min(8, lc)``, the last sample
    repeated into a short last group (a repeated segment adds nothing to a
    union).  Returns (cids (P, V), ok (P, V), spill (P,)), spill = union
    count beyond V (spill == 0 proves the sweep exhaustive).  ``live``
    (P,), when given, empties the lists of the pixels it marks False after
    the spill is counted: the caller discards their result."""
    origin = origin.detach()
    K = cs.lo.shape[0]
    P = origin.shape[0]
    V = max(1, min(visits, K))
    lo, hi = cs.lo.detach(), cs.hi.detach()

    def seg_overlap_group(d, md):
        """(P, K) union of one group's segment-slab overlaps; d (P, su, 3),
        md (P, su)."""
        tmin = tmax = None
        for c in range(3):
            dc = d[:, :, c, None]                               # (P, su, 1)
            dd = torch.where(torch.abs(dc) < 1e-30, 1e-30, dc)
            inv = 1.0 / dd
            oc = origin[:, c, None, None]                       # (P, 1, 1)
            t1 = (lo[None, None, :, c] - oc) * inv
            t2 = (hi[None, None, :, c] - oc) * inv
            a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
            # the JAX package starts from -FLT_MAX / FLT_MAX, which clips
            # only infinite slab distances: after the clamp at 0 and the
            # compare with the segment's end the overlaps are the same
            tmin = a if tmin is None else torch.maximum(tmin, a)
            tmax = b if tmax is None else torch.minimum(tmax, b)
        entry = torch.clamp(tmin, min=0.0)
        return ((tmax >= entry) & (entry < md[:, :, None])).any(1)

    union = torch.zeros((P, K), dtype=torch.bool, device=origin.device)
    for chunk_i in range(nchunks):
        d, md, _ = dirs_fn(chunk_i)
        d, md = d.detach(), md.detach()
        lc = md.shape[1]
        su = min(8, lc)
        pad = -(-lc // su) * su - lc
        if pad:
            d = torch.cat([d, d[:, -1:].expand(P, pad, 3)], 1)
            md = torch.cat([md, md[:, -1:].expand(P, pad)], 1)
        for g in range(0, lc + pad, su):
            union |= seg_overlap_group(d[:, g:g + su], md[:, g:g + su])

    n_union = union.sum(-1)
    spill = torch.clamp(n_union - V, min=0).to(torch.int32)
    if live is not None:
        union &= live[:, None]
    center = 0.5 * (lo + hi)
    rel = [center[None, :, c] - origin[:, c, None] for c in range(3)]
    key = torch.where(union, rel[0] * rel[0] + rel[1] * rel[1]
                      + rel[2] * rel[2], FLT_MAX)
    vals, idx = _k_smallest(key, V)
    return idx, vals < FLT_MAX, spill


def _mt_block_multi(blk, o, d):
    """Möller-Trumbore of a shared origin o (P, 3) against many directions
    d (P, S, 3) and one gathered block per pixel blk (P, F, C).  Returns
    (t, hit) each (P, S, C); the S-independent terms (s = o - v0,
    q = s × e1, the t numerator e2·q) are computed once per pixel."""
    def F(i):
        return blk[:, i, None, :]                          # (P, 1, C)
    dx, dy, dz = d[..., 0, None], d[..., 1, None], d[..., 2, None]
    e1x, e1y, e1z = F(_F_E1), F(_F_E1 + 1), F(_F_E1 + 2)
    e2x, e2y, e2z = F(_F_E2), F(_F_E2 + 1), F(_F_E2 + 2)
    eps = F(_F_EPS)

    sx, sy, sz = (o[:, i, None] - blk[:, _F_V0 + i] for i in range(3))
    qx = sy * blk[:, _F_E1 + 2] - sz * blk[:, _F_E1 + 1]
    qy = sz * blk[:, _F_E1] - sx * blk[:, _F_E1 + 2]
    qz = sx * blk[:, _F_E1 + 1] - sy * blk[:, _F_E1]
    tnum = (blk[:, _F_E2] * qx + blk[:, _F_E2 + 1] * qy
            + blk[:, _F_E2 + 2] * qz)                      # (P, C)

    hx = dy * e2z - dz * e2y                               # (P, S, C)
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = (a < eps) & (a > -eps)
    f = 1.0 / torch.where(parallel, 1.0, a)
    u = f * (sx[:, None] * hx + sy[:, None] * hy + sz[:, None] * hz)
    v = f * (dx * qx[:, None] + dy * qy[:, None] + dz * qz[:, None])
    t = f * tnum[:, None]
    hit = (~parallel & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
           & (t > eps))
    return t, hit


def shadow_shortlist(cs: ClusterSet, origin, cids, ok, ecenter, erad,
                     k_short: int):
    """Per-pixel shortlist of the ``k_short`` candidate triangles nearest
    the origin whose bounding spheres overlap the shadow capsule.

    origin: (P, 3); cids/ok: (P, V) from shadow_visit_order; ecenter (3,),
    erad ().  Returns (blk (P, F, K) gathered triangle rows, gid (P, K)
    global prim ids, lane_ok (P, K))."""
    origin = origin.detach()
    C = cs.blk.shape[2]
    P, V = cids.shape
    K = min(k_short, V * C)

    seg = ecenter[None] - origin                            # (P, 3)
    seglen2 = torch.clamp(_sum3(seg * seg), min=1e-30)
    seglen = v3m.sqrt(seglen2)
    b = cs.bound[cids]                                      # (P, V, C, 4)
    rad = b[..., 3]
    rel = [b[..., c] - origin[:, c, None, None] for c in range(3)]
    sg = [seg[:, c, None, None] for c in range(3)]
    dot = rel[0] * sg[0] + rel[1] * sg[1] + rel[2] * sg[2]  # (P, V, C)
    dist2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
    l2 = seglen2[:, None, None]
    s = torch.clamp(dot / l2, 0.0, 1.0)
    # the residual componentwise: the expanded form cancels for centroids
    # near the chord
    cx, cy, cz = (rel[c] - s * sg[c] for c in range(3))
    d2 = cx * cx + cy * cy + cz * cz
    # the largest chord fraction any point of the bounding sphere projects
    # to: the capsule widens along the chord
    s_hi = torch.clamp((dot + rad * seglen[:, None, None]) / l2, 0.0, 1.0)
    margin = rad + s_hi * erad
    overlap = (d2 <= margin * margin) & (rad >= 0) & ok[:, :, None]
    scores = torch.where(overlap, dist2, FLT_MAX).reshape(P, V * C)
    flat_ti = (cids[:, :, None] * C
               + torch.arange(C, device=cids.device)).reshape(P, V * C)
    vals, ti = _k_smallest_payload(scores, flat_ti, K)
    lane_ok = vals < FLT_MAX
    ti = torch.where(lane_ok, ti, 0)
    blk = cs.flat[ti].transpose(1, 2)                       # (P, F, K)
    return blk, cs.gid0 + ti, lane_ok


def any_hit_tint_shortlist(cs: ClusterSet, origin, blk, gid, lane_ok,
                           dirs_fn, nchunks, acc):
    """Shared-origin soft-shadow sweep over the per-pixel shortlist.

    blk (P, F, K), gid (P, K), lane_ok (P, K) from shadow_shortlist;
    dirs_fn(chunk_i) -> (d (P, lc, 3), max_dist (P, lc), exclude_gid
    (P, lc)).  acc: blocked (P, nchunks, lc) for opaque scenes, (blocked,
    counts (P, nchunks, lc, n_slots)) else.  Returns the updated acc (new
    tensors; the inputs are not changed)."""
    chunks = []
    for chunk_i in range(nchunks):
        d, max_dist, exclude_gid = dirs_fn(chunk_i)
        t, hit = _mt_block_multi(blk, origin, d)           # (P, lc, K)
        in_range = (hit & lane_ok[:, None, :] & (t < max_dist[..., None])
                    & (gid[:, None, :] != exclude_gid[..., None]))
        sub = _chunk_of(acc, chunk_i)
        chunks.append(_fold_blockers(cs, sub, in_range, blk, gid[:, None],
                                     -1))
    return _stack_chunks(chunks)


def _chunk_of(acc, chunk_i):
    """Chunk ``chunk_i`` (axis 1) of an accumulator."""
    if isinstance(acc, tuple):
        return tuple(a[:, chunk_i] for a in acc)
    return acc[:, chunk_i]


def _stack_chunks(chunks):
    """The accumulators of each chunk, stacked on axis 1."""
    if isinstance(chunks[0], tuple):
        return tuple(torch.stack(parts, 1) for parts in zip(*chunks))
    return torch.stack(chunks, 1)


def any_hit_tint_shared(cs: ClusterSet, origin, cids, ok, dirs_fn, nchunks,
                        acc, *, dead_skip: bool = False, steps=None):
    """Shared-origin soft-shadow sweep over the visited blocks (the union
    sweep and the ``bvh_shadow_shortlist=0`` route): each sample
    chunk runs every visit slot of every pixel in one call of
    ``union_sweep.union_visits`` (kernel 4 on the card).  Arguments and
    accumulators as in any_hit_tint_shortlist, with cids/ok (P, V) from
    a visit order.  ``steps``: the counter (core/tracing.py) that the
    visit steps run add to, or None."""
    n_steps = _visit_limit(ok, dead_skip)
    if steps:
        tracing.count(steps, n_steps)
    cids, ok = cids.contiguous(), ok.contiguous()
    chunks = []
    for chunk_i in range(nchunks):
        d, max_dist, exclude_gid = dirs_fn(chunk_i)
        sub = _chunk_of(acc, chunk_i)
        sub = (tuple(a.contiguous() for a in sub) if isinstance(sub, tuple)
               else sub.contiguous())
        chunks.append(union_sweep.union_visits(
            cs, origin, cids, ok, n_steps, d, max_dist, exclude_gid, sub))
    return _stack_chunks(chunks)

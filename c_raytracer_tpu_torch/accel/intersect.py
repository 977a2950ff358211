"""Scene intersector, as in ``c_raytracer_tpu.accel.intersect``: dense
sweeps, or the Morton-cluster sweep for mesh scenes.

Spheres and planes are always swept densely (reference scenes have a
handful; planes are outside the BVH in the reference too, object.h:84).
Triangles go through the cluster sweep (traverse.py, with the visit-order
kernel) from ``AUTO_THRESHOLD`` triangles on, densely below it.  The
interface is SoA (``V3`` component tensors); the cluster sweep works on
(R, 3) rays and converts at this seam.

Not ported yet, and refused with ``NotImplementedError`` when a cluster
route would take them: union shadow mode (ROADMAP: the stack integrator
with union mode), ``bvh_super_group`` (ROADMAP: the super and sharded
sweeps), ``closest_compact="on"`` (ROADMAP: the super and sharded sweeps)
and primitive-range shards (ROADMAP: multi-GPU).
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.accel import traverse
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.geometry import primitives as G

# dense is faster below this triangle count (the JAX package's threshold)
AUTO_THRESHOLD = 512


@dataclasses.dataclass(frozen=True)
class Intersector:
    """Query object used by the integrator and shading."""

    ds: G.DeviceScene
    static: object
    cfg: object
    clusters: traverse.ClusterSet | None = None
    # the shadow sweep's own cluster set when its cluster size differs from
    # the main one (bvh_shadow_cluster); None -> the main set
    shadow_clusters: traverse.ClusterSet | None = None
    # the frame's occlusion results kept for the backward's recompute, by
    # sample path (core/remat.py); None when nothing is rematerialised
    saved_occlusion: dict | None = dataclasses.field(default=None,
                                                     compare=False)

    @property
    def _shadow_cs(self):
        return (self.shadow_clusters if self.shadow_clusters is not None
                else self.clusters)

    @property
    def _any_transparent(self) -> bool:
        return any(self.static.is_transparent)

    @property
    def _visits(self) -> int:
        return self.cfg.resolved_visits(self._any_transparent)

    @property
    def _shadow_visits(self) -> int:
        return self.cfg.resolved_shadow_visits(self._any_transparent)

    @property
    def _shadow_shortlist(self) -> int:
        return self.cfg.resolved_shadow_shortlist(self._any_transparent)

    @property
    def _dead_skip(self) -> bool:
        """Stop a sweep at the batch's longest visit list: "auto" does for
        transparent scenes (generous budgets, mostly dead tails), not for
        opaque ones, whose tight budgets run every visit."""
        mode = self.cfg.sweep_dead_skip
        if mode != "auto":
            return mode == "on"
        return self._any_transparent

    @property
    def resolved_shadow_mode(self) -> str:
        return self.cfg.resolved_shadow_mode(self._any_transparent)

    @property
    def use_shared_shadows(self) -> bool:
        """Whether soft shadows go through ``shadow_query`` (the
        shared-origin sweep) or through per-chunk ``any_tint``."""
        return (self.clusters is not None
                and self.resolved_shadow_mode in ("shared", "union"))

    @property
    def has_clusters(self) -> bool:
        return self.clusters is not None

    def closest(self, o: V3, d: V3, with_spill: bool = False):
        """(t, gid, mat, normal V3) over the whole scene; o/d V3 of (P,).

        ``with_spill``: also the per-lane int32 count of overlapped clusters
        beyond the visit budget (0 on the dense route, which is exhaustive;
        spill == 0 proves the cluster sweep exhaustive)."""
        if self.clusters is None:
            out = G.closest_hit_soa(self.ds, self.static, o, d,
                                    tri_chunk=self.cfg.tri_chunk)
            if with_spill:
                return out + (torch.zeros(o.x.shape, dtype=torch.int32,
                                          device=o.x.device),)
            return out
        t, gid, mat, n = G.closest_hit_soa(self.ds, self.static, o, d,
                                           include_triangles=False)

        def sweep(o2, d2, t, gid, n2):
            t, gid, n2, spill = traverse.closest_hit_clusters(
                self.clusters, o2, d2, (t, gid, n2), visits=self._visits,
                dead_skip=self._dead_skip, with_spill=True)
            return t, gid, n2, spill

        t, gid, n2, spill = self._chunked(
            sweep, (v3m.to_aos(o), v3m.to_aos(d), t, gid, v3m.to_aos(n)))
        # a triangle winner takes its material from the table; spheres and
        # planes carried theirs through the pre-pass
        ns, nt = self.static.n_spheres, self.static.n_triangles
        is_tri = (gid >= ns) & (gid < ns + nt)
        mat_tri = self.ds.mat_idx[gid.clamp(0, self.ds.mat_idx.shape[0] - 1)]
        out = (t, gid, torch.where(is_tri, mat_tri, mat), v3m.from_aos(n2))
        return out + (spill,) if with_spill else out

    def any_tint(self, o: V3, d: V3, max_dist, exclude_gid,
                 with_spill: bool = False):
        """(blocked, tint V3) shadow query; o and d broadcast against each
        other (a (1, P) origin against (lc, P) directions).

        ``with_spill``: also the per-lane int32 count of in-range
        overlapped clusters beyond the shadow visit budget (0 on the dense
        route)."""
        lead = torch.broadcast_shapes(o.x.shape, d.x.shape)
        dev = d.x.device
        if self.clusters is None:
            out = G.any_hit_tint_soa(self.ds, self.static, o, d, max_dist,
                                     exclude_gid,
                                     tri_chunk=self.cfg.tri_chunk)
            if with_spill:
                return out + (torch.zeros(lead, dtype=torch.int32,
                                          device=dev),)
            return out
        blocked, tint = G.any_hit_tint_soa(self.ds, self.static, o, d,
                                           max_dist, exclude_gid,
                                           include_triangles=False)
        o2 = v3m.to_aos(o).expand(lead + (3,)).reshape(-1, 3)
        d2 = v3m.to_aos(d).expand(lead + (3,)).reshape(-1, 3)
        ex = torch.as_tensor(exclude_gid, device=dev).expand(lead).reshape(-1)

        def sweep(o2, d2, md, ex, blocked, tint):
            (blocked, tint), spill = traverse.any_hit_tint_clusters(
                self.clusters, o2, d2, md, ex, (blocked, tint),
                visits=self._shadow_visits, dead_skip=self._dead_skip,
                with_spill=True)
            return blocked, tint, spill

        blocked, tint, spill = self._chunked(sweep, (
            o2, d2, max_dist.expand(lead).reshape(-1), ex,
            blocked.expand(lead).reshape(-1),
            v3m.to_aos(tint).expand(lead + (3,)).reshape(-1, 3)))
        out = (blocked.reshape(lead), v3m.from_aos(tint.reshape(lead + (3,))))
        return out + (spill.reshape(lead),) if with_spill else out

    def shadow_query(self, origin: V3, emitter_lo, emitter_hi, dirs_fn, egid,
                     nchunks, lc):
        """Shared-origin soft-shadow query over all sample chunks at once
        ("shared" shadow mode).

        origin: V3 (P,) hit points; emitter_lo/hi: (3,) emitter AABB;
        dirs_fn(chunk_i) -> (ldir V3 (lc, P), ldist (lc, P)), the chunk's
        sample directions (drawn once by the caller).  Returns (blocked
        (nchunks, lc, P), tint, spill_max): tint is (tx, ty, tz) each
        (nchunks, lc, P) for scenes with transparent materials and None
        otherwise (opaque occlusion is all in ``blocked``); spill_max is 0
        (the capsule list has no truncation guard)."""
        if self.resolved_shadow_mode == "union":
            raise NotImplementedError(
                "union shadow mode is not ported yet (ROADMAP: the stack "
                "integrator with union mode)")
        scs = self._shadow_cs
        has_transp = scs.has_transp

        # sphere/plane pre-pass per chunk; the chunk's directions in the
        # (P, lc, ...) layout the cluster sweeps take
        blocked, tints, dirs = [], [], []
        for chunk_i in range(nchunks):
            ldir, ldist = dirs_fn(chunk_i)
            b, tn = G.any_hit_tint_soa(
                self.ds, self.static, origin.map(lambda x: x[None]), ldir,
                ldist, egid, include_triangles=False)
            blocked.append(b)
            tints.append(v3m.to_aos(tn).expand(b.shape + (3,)))
            dirs.append((v3m.to_aos(ldir).transpose(0, 1).contiguous(),
                         ldist.transpose(0, 1).contiguous()))
        blocked_pm = torch.stack(blocked, 1).permute(2, 1, 0)  # (P, nc, lc)

        def cached_dirs(chunk_i):
            d, md = dirs[chunk_i]
            return d, md, torch.full(md.shape, egid, device=md.device)

        origin_aos = v3m.to_aos(origin).contiguous()
        if has_transp:
            tint_pm = torch.stack(tints, 1).permute(2, 1, 0, 3)
            acc = (blocked_pm, tint_pm)                 # (P, nc, lc[, 3])
        else:
            acc = blocked_pm
        cids, ok = traverse.shadow_visit_order(scs, origin_aos, emitter_lo,
                                               emitter_hi, self._shadow_visits)
        k_short = self._shadow_shortlist
        if k_short:
            # triangle-level shortlist: score once per pixel, then stream
            # the sample chunks against K triangles instead of visits × C
            ecenter = 0.5 * (emitter_lo + emitter_hi)
            erad = 0.5 * traverse._norm3(emitter_hi - emitter_lo)
            sblk, sgid, lane_ok = traverse.shadow_shortlist(
                scs, origin_aos, cids, ok, ecenter, erad, k_short)
            acc = traverse.any_hit_tint_shortlist(
                scs, origin_aos, sblk, sgid, lane_ok, cached_dirs, nchunks,
                acc)
        else:
            acc = traverse.any_hit_tint_shared(
                scs, origin_aos, cids, ok, cached_dirs, nchunks, acc,
                dead_skip=self._dead_skip)
        if not has_transp:
            return acc.permute(1, 2, 0), None, 0
        blocked2, tint2 = acc
        tint_out = tint2.permute(1, 2, 0, 3)                # (nc, lc, P, 3)
        return (blocked2.permute(1, 2, 0),
                (tint_out[..., 0], tint_out[..., 1], tint_out[..., 2]), 0)

    @torch.no_grad()
    def emitter_bounds(self, egid: int):
        """(lo, hi) AABB of emitter primitive ``egid``; selection only, so
        without gradient (the JAX package stops it here)."""
        ds = self.ds
        ns = ds.sph_center.shape[0]
        if egid < ns:
            c, r = ds.sph_center[egid], ds.sph_radius[egid]
            return c - r, c + r
        ti = egid - ns
        v0 = ds.tri_v0[ti]
        v1 = v0 + ds.tri_e1[ti]
        v2 = v0 + ds.tri_e2[ti]
        return (torch.minimum(torch.minimum(v0, v1), v2),
                torch.maximum(torch.maximum(v0, v1), v2))

    def _chunked(self, fn, args):
        """fn over slices of ``cfg.bvh_ray_chunk`` rays of the tensors
        ``args`` (all with the ray axis leading); concatenates fn's outputs.
        Every ray's result is independent of the slicing."""
        n, chunk = args[0].shape[0], self.cfg.bvh_ray_chunk
        if n <= chunk:
            return fn(*args)
        outs = [fn(*(a[i:i + chunk] for a in args))
                for i in range(0, n, chunk)]
        return tuple(torch.cat(parts) for parts in zip(*outs))


def make_intersector(ds: G.DeviceScene, static, cfg,
                     shards=None) -> Intersector:
    """The intersector of a scene: dense below ``AUTO_THRESHOLD``
    triangles (``cfg.accel="auto"``), clusters packed from the current
    vertices otherwise, with a separate shadow cluster set when
    ``bvh_shadow_cluster`` differs from ``bvh_cluster``."""
    if shards is not None:
        raise NotImplementedError(
            "primitive-range shards are not ported yet (ROADMAP: multi-GPU)")
    nt = ds.tri_v0.shape[0]
    mode = cfg.accel
    if mode == "auto":
        mode = "cluster" if nt >= AUTO_THRESHOLD else "none"
    if mode != "cluster" or not nt:
        return Intersector(ds=ds, static=static, cfg=cfg)
    any_transp = any(static.is_transparent)
    clusters = traverse.pack_clusters(ds, static, cfg.bvh_cluster)
    if cfg.resolved_super_group(any_transp, clusters.lo.shape[0]):
        raise NotImplementedError(
            "bvh_super_group is not ported yet (ROADMAP: the super and "
            "sharded sweeps)")
    if cfg.closest_compact == "on":
        raise NotImplementedError(
            'closest_compact="on" is not ported yet (ROADMAP: the super and '
            "sharded sweeps)")
    c_shadow = cfg.resolved_shadow_cluster(any_transp)
    shadow_clusters = None
    if (cfg.resolved_shadow_mode(any_transp) in ("shared", "union")
            and c_shadow != cfg.bvh_cluster):
        shadow_clusters = traverse.pack_clusters(ds, static, c_shadow)
    return Intersector(ds=ds, static=static, cfg=cfg, clusters=clusters,
                       shadow_clusters=shadow_clusters)

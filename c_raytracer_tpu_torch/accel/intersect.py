"""Scene intersector, as in ``c_raytracer_tpu.accel.intersect``: dense
sweeps, or the Morton-cluster sweep for mesh scenes.

Spheres and planes are always swept densely (reference scenes have a
handful; planes are outside the BVH in the reference too, object.h:84).
Triangles go through the cluster sweep (traverse.py, with the visit-order
kernel) from ``AUTO_THRESHOLD`` triangles on, densely below it.  The
interface is SoA (``V3`` component tensors); the cluster sweep works on
(R, 3) rays and converts at this seam.

Shadow queries return a count of blockers per transparent material beside
the opaque ``blocked`` mask (geometry/primitives.py ``tint_slots``);
``tint`` forms the light's kt tint from it, differentiably.

The opt-ins of the JAX package's cluster sweeps are taken by the same
rules: ``bvh_super_group`` (the two-level visit order of the closest-hit
and per-ray sweeps, GI child traces and the stack integrator's traces
included) and ``closest_compact="on"`` (closest-hit ray compaction in
blocks of 8192 rays down to 128, two or more of them).

Primitive-range shards (geometry/sharded.py ``TriShards``): each shard
sweeps its own triangle range, densely or through its own cluster sets
(``traverse.pack_clusters_sharded``), and the per-shard results fold
across shards, stacked in this process or gathered across the ``pr``
ranks.  Unlike the JAX package's sharded sweeps, each shard's sweep takes
the same opt-ins as the unsharded one (``closest_compact``,
``bvh_super_group``, ``sweep_dead_skip``).

Spans (core/tracing.py): ``crt.intersect.closest``, ``.retest`` and
``.shadow`` (``any_counts``, ``shadow_query``) around each query, and
``crt.intersect.union_block`` around the union sweep of each union shadow
query, which counts ``union_blocks`` and, in traverse.py, ``union_steps``.
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.accel import traverse
from c_raytracer_tpu_torch.core import tracing
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.geometry import primitives as G
from c_raytracer_tpu_torch.geometry import sharded

# dense is faster below this triangle count (the JAX package's threshold)
AUTO_THRESHOLD = 512


@dataclasses.dataclass(frozen=True)
class Intersector:
    """Query object used by the integrator and shading."""

    ds: G.DeviceScene
    static: object
    cfg: object
    # a ClusterSet, or with shards a tuple of them, one a local shard
    clusters: traverse.ClusterSet | tuple | None = None
    # the shadow sweep's own cluster set(s) when its cluster size differs
    # from the main one (bvh_shadow_cluster); None -> the main set(s)
    shadow_clusters: traverse.ClusterSet | tuple | None = None
    # primitive-range shards (geometry/sharded.py), None for none
    shards: sharded.TriShards | None = None
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
        shared-origin sweep) or through per-chunk ``any_counts``."""
        return (self.clusters is not None
                and self.resolved_shadow_mode in ("shared", "union"))

    @property
    def has_clusters(self) -> bool:
        return self.clusters is not None

    @tracing.spanned("intersect.closest")
    def closest(self, o: V3, d: V3, with_spill: bool = False):
        """(t, gid, mat, normal V3) over the whole scene; o/d V3 of (P,).

        ``with_spill``: also the per-lane int32 count of overlapped clusters
        beyond the visit budget (0 on the dense route, which is exhaustive;
        spill == 0 proves the cluster sweep exhaustive)."""
        if self.clusters is None:
            if self.shards is not None:
                out = sharded.closest_hit_sharded(self.ds, self.static,
                                                  self.shards, o, d)
            else:
                out = G.closest_hit_soa(self.ds, self.static, o, d,
                                        tri_chunk=self.cfg.tri_chunk)
            if with_spill:
                return out + (torch.zeros(o.x.shape, dtype=torch.int32,
                                          device=o.x.device),)
            return out
        t, gid, mat, n = G.closest_hit_soa(self.ds, self.static, o, d,
                                           include_triangles=False)
        if self.shards is not None:
            return self._closest_sharded(o, d, (t, gid, mat, n), with_spill)

        def sweep(o2, d2, t, gid, n2):
            t, gid, n2, spill = traverse.closest_hit_clusters(
                self.clusters, o2, d2, (t, gid, n2), visits=self._visits,
                dead_skip=self._dead_skip, with_spill=True,
                super_group=self._super_group(self.clusters),
                super_sel=self.cfg.bvh_super_sel,
                compact_block=self._closest_compact_block(o2.shape[0]))
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

    def _closest_sharded(self, o: V3, d: V3, best, with_spill: bool):
        """``closest`` over sharded clusters: each local shard's sorted
        cluster sweep (without autograd) from an empty best, the
        cross-shard fold (global min over t, ties to the lowest id), then
        the sphere/plane challenge on a strictly smaller t
        (``sharded.merge_closest``).  The spill is the max over shards."""
        @torch.no_grad()
        def sweep(o2, d2):
            R = o2.shape[0]
            parts = []
            for cs in self.clusters:
                t, g, sp = (
                    torch.full((R,), traverse.FLT_MAX, device=o2.device),
                    torch.full((R,), sharded.NO_GID, dtype=torch.int64,
                               device=o2.device),
                    torch.zeros(R, dtype=torch.int32, device=o2.device))
                if cs is not None:   # None: a shard without a triangle
                    t, g, _, sp = traverse.closest_hit_clusters(
                        cs, o2, d2, (t, g, o2.new_zeros((R, 3))),
                        visits=self._visits, dead_skip=self._dead_skip,
                        with_spill=True, super_group=self._super_group(cs),
                        super_sel=self.cfg.bvh_super_sel,
                        compact_block=self._closest_compact_block(R))
                row = sharded.closest_row(t, g)
                parts.append(torch.cat([row, sp.to(row.dtype)[:, None]], 1))
            data = sharded.stack_shards(parts, self.shards)   # (S, R, 3)
            return sharded.fold_closest(data[..., :2]) + (
                data[..., 2].amax(0).to(torch.int32),)

        t, g, found, spill = self._chunked(
            sweep, (v3m.to_aos(o), v3m.to_aos(d)))
        out = sharded.merge_closest(self.ds, self.static, best, o, d, t, g,
                                    found)
        return out + (spill,) if with_spill else out

    @tracing.spanned("intersect.retest")
    def retest(self, o: V3, d: V3, gid):
        """Single-primitive inside-object re-test (render.c:143-144) of
        primitive ``gid`` (P,), -1 for none.  Returns (t, hit, normal).
        With shards too it reads the replicated tables, which every rank
        holds: the JAX package routes it through the owner shard so that
        no device keeps them, and the owner's test is this one, bit for
        bit."""
        return G.intersect_prim_soa(self.ds, o, d, gid)

    def tint(self, counts) -> V3:
        """The kt tint of shadow segments from their blocker counts
        (``any_counts``, ``shadow_query``), differentiable into
        ``materials.kt``."""
        return G.tint_from_counts(self.ds.materials.kt,
                                  G.tint_slots(self.static), counts)

    @tracing.spanned("intersect.shadow")
    def any_counts(self, o: V3, d: V3, max_dist, exclude_gid,
                   with_spill: bool = False):
        """(blocked, counts) shadow query; o and d broadcast against each
        other (a (1, P) origin against (lc, P) directions).  ``counts``
        (..., n_slots) int16 counts each sample's in-range blockers of each
        transparent material, None in a scene without one.

        ``with_spill``: also the per-lane int32 count of in-range
        overlapped clusters beyond the shadow visit budget (0 on the dense
        route)."""
        lead = torch.broadcast_shapes(o.x.shape, d.x.shape)
        dev = d.x.device
        if self.clusters is None:
            if self.shards is not None:
                out = sharded.any_hit_counts_sharded(
                    self.ds, self.static, self.shards, o, d, max_dist,
                    exclude_gid)
            else:
                out = G.any_hit_counts_soa(self.ds, self.static, o, d,
                                           max_dist, exclude_gid,
                                           tri_chunk=self.cfg.tri_chunk)
            if with_spill:
                return out + (torch.zeros(lead, dtype=torch.int32,
                                          device=dev),)
            return out
        blocked, counts = G.any_hit_counts_soa(self.ds, self.static, o, d,
                                               max_dist, exclude_gid,
                                               include_triangles=False)
        if self.shards is not None:
            return self._any_counts_sharded(o, d, max_dist, exclude_gid,
                                            blocked, counts, with_spill)
        cs = self.clusters
        o2 = v3m.to_aos(o).expand(lead + (3,)).reshape(-1, 3)
        d2 = v3m.to_aos(d).expand(lead + (3,)).reshape(-1, 3)
        _count_copy(exclude_gid)
        ex = torch.as_tensor(exclude_gid, device=dev).expand(lead).reshape(-1)
        args = [o2, d2, max_dist.expand(lead).reshape(-1), ex,
                blocked.expand(lead).reshape(-1)]
        if cs.has_transp:
            args.append(counts.expand(lead + counts.shape[-1:])
                        .reshape(-1, counts.shape[-1]))

        def sweep(o2, d2, md, ex, *acc):
            acc, spill = traverse.any_hit_tint_clusters(
                cs, o2, d2, md, ex, acc if cs.has_transp else acc[0],
                visits=self._shadow_visits, dead_skip=self._dead_skip,
                with_spill=True, super_group=self._super_group(cs),
                super_sel=self.cfg.bvh_super_sel)
            return (acc if cs.has_transp else (acc,)) + (spill,)

        *acc, spill = self._chunked(sweep, args)
        blocked = acc[0].reshape(lead)
        if cs.has_transp:
            counts = acc[1].reshape(lead + acc[1].shape[-1:])
        out = (blocked, counts)
        return out + (spill.reshape(lead),) if with_spill else out

    def _any_counts_sharded(self, o: V3, d: V3, max_dist, exclude_gid,
                            blocked, counts, with_spill: bool):
        """``any_counts`` over sharded clusters: each local shard's
        per-ray sweep from empty accumulators, folded across shards (the
        OR, the counts added, the spill's max) into the sphere/plane
        pre-pass ``blocked`` and ``counts``."""
        lead = blocked.shape
        dev = blocked.device
        has_transp = self.shards.kt is not None
        n_slots = len(G.tint_slots(self.static)) if has_transp else 0
        o2 = v3m.to_aos(o).expand(lead + (3,)).reshape(-1, 3)
        d2 = v3m.to_aos(d).expand(lead + (3,)).reshape(-1, 3)
        _count_copy(exclude_gid)
        ex = torch.as_tensor(exclude_gid, device=dev).expand(lead).reshape(-1)

        def sweep(o2, d2, md, ex):
            R = o2.shape[0]
            parts = []
            for cs in self.clusters:
                acc = torch.zeros(R, dtype=torch.bool, device=dev)
                if has_transp:
                    acc = (acc, torch.zeros((R, n_slots), dtype=torch.int16,
                                            device=dev))
                sp = torch.zeros(R, dtype=torch.int32, device=dev)
                if cs is not None:   # None: a shard without a triangle
                    acc, sp = traverse.any_hit_tint_clusters(
                        cs, o2, d2, md, ex, acc, visits=self._shadow_visits,
                        dead_skip=self._dead_skip, with_spill=True,
                        super_group=self._super_group(cs),
                        super_sel=self.cfg.bvh_super_sel)
                b, c = acc if has_transp else (acc, None)
                parts.append(sharded.counts_row(b, c, sp))
            b, c, sp = sharded.fold_counts(
                sharded.stack_shards(parts, self.shards), n_slots)
            return (b, sp) if c is None else (b, sp, c)

        b, spill, *c = self._chunked(
            sweep, (o2, d2, max_dist.expand(lead).reshape(-1), ex))
        blocked = blocked | b.reshape(lead)
        if c:
            counts = counts + c[0].reshape(lead + (n_slots,))
        out = (blocked, counts)
        return out + (spill.reshape(lead),) if with_spill else out

    def _super_group(self, cs) -> int:
        """G of the two-level visit order over the cluster set ``cs``, 0
        for the dense one (``bvh_super_group``; its auto is 0)."""
        return self.cfg.resolved_super_group(self._any_transparent,
                                             cs.lo.shape[0])

    def _closest_compact_block(self, n_rays: int) -> int:
        """Rays a block of closest-hit compaction (0 = off): with
        ``closest_compact="on"`` the largest power of two from 8192 down to
        128 that divides the batch, when that makes two or more blocks
        (smaller blocks starve each visit step).  The JAX package's loop
        can stop at 64, below that floor; here no block is under 128."""
        if self.cfg.closest_compact != "on":
            return 0
        pb = 8192
        while pb >= 128 and n_rays % pb:
            pb //= 2
        if pb < 128 or n_rays % pb or n_rays // pb < 2:
            return 0
        return pb

    def _union_sweep(self, scs, origin_aos, dirs, egid, acc, live):
        """The union shadow sweep of ``shadow_query`` over the cluster set
        ``scs``: (acc, spill_max).  One union list per pixel over all its
        samples, and every sample tested against each listed cluster in
        one step, as one union block.  The JAX package steps chunk by
        chunk, and its schedules may sweep a list per chunk or the pixels
        in blocks sorted by list length; blocked and counts depend on none
        of that, and kernel 4 walks only each pixel's own live slots."""
        P = origin_aos.shape[0]
        nc = len(dirs)
        lc = dirs[0][1].shape[1]

        def dirs_of(ds_):
            def fn(chunk_i):
                d, md = ds_[chunk_i]
                return d, md, torch.full(md.shape, egid, device=md.device)
            return fn

        cids, ok, spill = traverse.shadow_union_visit_order(
            scs, origin_aos, dirs_of(dirs), nc,
            self.cfg.resolved_union_visits(scs.has_transp), live)
        # all samples as one chunk: (P, nc·lc, ...)
        flat = [(torch.cat([d for d, _ in dirs], 1),
                 torch.cat([md for _, md in dirs], 1))]
        acc1 = (tuple(a.reshape((P, 1, nc * lc) + a.shape[3:]) for a in acc)
                if isinstance(acc, tuple)
                else acc.reshape(P, 1, nc * lc))
        with tracing.span("intersect.union_block"):
            tracing.count("union_blocks")
            out = traverse.any_hit_tint_shared(
                scs, origin_aos, cids, ok, dirs_of(flat), 1, acc1,
                dead_skip=self._dead_skip, steps="union_steps")
        out = (tuple(a.reshape((P, nc, lc) + a.shape[3:]) for a in out)
               if isinstance(out, tuple) else out.reshape(P, nc, lc))
        return out, spill.max()

    @tracing.spanned("intersect.shadow")
    def shadow_query(self, origin: V3, emitter_lo, emitter_hi, dirs_fn, egid,
                     nchunks, lc, live=None):
        """Shared-origin soft-shadow query over all sample chunks at once
        ("shared" and "union" shadow modes).

        origin: V3 (P,) hit points; emitter_lo/hi: (3,) emitter AABB;
        dirs_fn(chunk_i) -> (ldir V3 (lc, P), ldist (lc, P)), the chunk's
        sample directions (drawn once by the caller).  Returns (blocked
        (nchunks, lc, P), counts, spill_max): counts (nchunks, lc, P,
        n_slots) when a transparent material is among the shadow clusters'
        triangles or the spheres and planes, else None; spill_max, a 0-d
        int32 tensor, the union lists' worst truncation over all P pixels
        (0 in "shared" mode, whose capsule list has no truncation guard).
        ``live`` (P,): in "union" mode, pixels whose result the caller
        discards, which the sweep then skips.

        The JAX package drops the sphere/plane pre-pass counts when the
        shadow clusters hold no transparent triangle, so there a glass
        sphere casts no shadow at all in the union and shared modes, while
        its per-ray mode tints; the port keeps them in every mode."""
        scs = self._shadow_cs
        has_transp = (scs.has_transp if self.shards is None
                      else self.shards.kt is not None)

        # sphere/plane pre-pass per chunk; the chunk's directions in the
        # (P, lc, ...) layout the cluster sweeps take
        blocked, counts, dirs = [], [], []
        for chunk_i in range(nchunks):
            ldir, ldist = dirs_fn(chunk_i)
            b, cnt = G.any_hit_counts_soa(
                self.ds, self.static, origin.map(lambda x: x[None]), ldir,
                ldist, egid, include_triangles=False)
            blocked.append(b)
            counts.append(cnt)
            dirs.append((v3m.to_aos(ldir).transpose(0, 1).contiguous(),
                         ldist.transpose(0, 1).contiguous()))
        blocked_pm = torch.stack(blocked, 1).permute(2, 1, 0)  # (P, nc, lc)

        def cached_dirs(chunk_i):
            d, md = dirs[chunk_i]
            return d, md, torch.full(md.shape, egid, device=md.device)

        origin_aos = v3m.to_aos(origin).contiguous()
        # the pre-pass counts of transparent spheres and planes, kept
        # beside an opaque cluster sweep's mask
        pre_counts = None
        if has_transp:
            counts_pm = torch.stack(counts, 1).permute(2, 1, 0, 3)
            acc = (blocked_pm, counts_pm)            # (P, nc, lc[, slots])
        else:
            acc = blocked_pm
            if counts[0] is not None:
                pre_counts = torch.stack(counts, 0)   # (nc, lc, P, slots)
        args = (origin_aos, dirs, cached_dirs, egid, emitter_lo, emitter_hi,
                live)
        if self.shards is None:
            acc, spill_max = self._shadow_sweep(scs, acc, *args)
        else:
            acc, spill_max = self._shadow_sweep_sharded(acc, *args)
        return _query_out(acc, spill_max, pre_counts)

    def _shadow_sweep(self, scs, acc, origin_aos, dirs, cached_dirs, egid,
                      emitter_lo, emitter_hi, live):
        """The cluster part of ``shadow_query`` over the cluster set
        ``scs``: the union sweep, or the capsule list with the shortlist
        or shared sweep.  Returns (acc, spill_max)."""
        if self.resolved_shadow_mode == "union":
            return self._union_sweep(scs, origin_aos, dirs, egid, acc, live)
        spill_max = torch.zeros((), dtype=torch.int32,
                                device=origin_aos.device)
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
                scs, origin_aos, sblk, sgid, lane_ok, cached_dirs, len(dirs),
                acc)
        else:
            acc = traverse.any_hit_tint_shared(
                scs, origin_aos, cids, ok, cached_dirs, len(dirs), acc,
                dead_skip=self._dead_skip)
        return acc, spill_max

    def _shadow_sweep_sharded(self, acc, *args):
        """``_shadow_sweep`` of each local shard's cluster set from empty
        accumulators, folded across shards (the OR, the counts added, the
        spill's max) into the pre-pass accumulator ``acc``."""
        has_transp = isinstance(acc, tuple)
        parts = []
        for scs in self._shadow_cs:
            a = (tuple(torch.zeros_like(x) for x in acc) if has_transp
                 else torch.zeros_like(acc))
            sp = torch.zeros((), dtype=torch.int32, device=a[0].device)
            if scs is not None:   # None: a shard without a triangle
                a, sp = self._shadow_sweep(scs, a, *args)
            b, c = a if has_transp else (a, None)
            parts.append(sharded.counts_row(b, c, sp))
        n_slots = acc[1].shape[-1] if has_transp else 0
        b, c, sp = sharded.fold_counts(
            sharded.stack_shards(parts, self.shards), n_slots)
        if not has_transp:
            return acc | b, sp.max()
        return (acc[0] | b, acc[1] + c), sp.max()

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


def _count_copy(exclude_gid) -> None:
    """Count the copy of a host ``exclude_gid`` to the device."""
    if not isinstance(exclude_gid, torch.Tensor):
        tracing.count("sync.exclude_gid")


def _query_out(acc, spill_max, pre_counts=None):
    """``shadow_query``'s result from its (P, nc, lc[, slots]) accumulator:
    (blocked (nc, lc, P), counts (nc, lc, P, slots) or None, spill_max);
    an opaque sweep's counts are the pre-pass's ``pre_counts``."""
    if not isinstance(acc, tuple):
        return acc.permute(1, 2, 0), pre_counts, spill_max
    blocked, counts = acc
    return blocked.permute(1, 2, 0), counts.permute(1, 2, 0, 3), spill_max


def make_intersector(ds: G.DeviceScene, static, cfg,
                     shards=None) -> Intersector:
    """The intersector of a scene: dense below ``AUTO_THRESHOLD``
    triangles (``cfg.accel="auto"``), clusters packed from the current
    vertices otherwise, with a separate shadow cluster set when
    ``bvh_shadow_cluster`` differs from ``bvh_cluster``.  ``shards``
    (geometry/sharded.py ``shard_triangles``) splits the triangles into
    ranges, a cluster pack each on the cluster route."""
    nt = ds.tri_v0.shape[0]
    mode = cfg.accel
    if mode == "auto":
        mode = "cluster" if nt >= AUTO_THRESHOLD else "none"
    if not nt:
        shards = None
    if mode != "cluster" or not nt:
        return Intersector(ds=ds, static=static, cfg=cfg, shards=shards)
    any_transp = any(static.is_transparent)
    if shards is None:
        def pack(c):
            return traverse.pack_clusters(ds, static, c)
    else:
        def pack(c):
            return traverse.pack_clusters_sharded(shards, static, c)
    clusters = pack(cfg.bvh_cluster)
    c_shadow = cfg.resolved_shadow_cluster(any_transp)
    shadow_clusters = None
    if (cfg.resolved_shadow_mode(any_transp) in ("shared", "union")
            and c_shadow != cfg.bvh_cluster):
        shadow_clusters = pack(c_shadow)
    return Intersector(ds=ds, static=static, cfg=cfg, clusters=clusters,
                       shadow_clusters=shadow_clusters, shards=shards)

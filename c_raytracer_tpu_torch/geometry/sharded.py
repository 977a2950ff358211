"""Primitive-range sharding, as in ``c_raytracer_tpu.geometry.sharded``:
the triangle arrays split into S contiguous ranges.

Each shard folds its own triangle range (closest hit: running min over t;
shadows: the blocked OR and the blocker counts, accel.c:322-387), and the
per-shard results combine:

* closest hit — global min over t, ties to the lowest global primitive id
  (the reference's strictly-smaller-t fold order, accel.c:328);
* shadows — ``blocked`` is an OR and the per-material blocker counts add,
  exactly; the JAX package multiplies kt tints over the shards instead,
  which regroups the product at shard boundaries (~1 ulp).

A process holds its shards in one of two ways.  Stacked: all S in this
process (``owned=None``), as the JAX package runs them on one device
without a sharding.  Owned: shard ``k`` alone (``owned=k``), one shard a
rank of the ``pr`` process group (parallel/mesh.py).  The folds take the
per-shard results stacked on a leading axis (S, ...) either way: the local
shards' from a loop, or every rank's from one all-gather across the
group (``stack_shards``).  Both feed the same fold, so S stacked shards
and S ranks give bit-identical results.

Gradients: only selection crosses shards.  Each shard's sweep runs
without autograd and the folds gather ids, t, masks and counts; the
winner's differentiable t and normal are formed again from the
replicated triangle tables (``merge_closest``: the fold's t value, the
gradient of the winner's own Möller-Trumbore test).  So the backward runs
no collective, and the ranks of a ``pr`` group, whose graphs are then the
same, shade the same pixels with the same graph: each carries 1/n_pr of
the loss (parallel/train.py).  (A differentiable all-gather of the
per-shard hits deadlocked on the card: each rank's own sweep gave its
backward another graph, and the autograd engine issued the ranks'
collectives in different orders.)  The inside-object re-test needs no
shard: every rank holds the replicated tables, whose re-test is the owner
shard's, bit for bit (``Intersector.retest``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c_raytracer_tpu_torch.core import comm, tracing
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.geometry import primitives as G

FLT_MAX = G.FLT_MAX
# a shard's gid where it hit nothing: above every primitive id, and exact
# in float32, the type the per-shard data crosses ranks in
NO_GID = 1 << 24


@dataclasses.dataclass(frozen=True)
class TriShards:
    """The triangle arrays of this process's shards, stacked (S_local, m).

    Rows are differentiable views of the ``DeviceScene``'s triangle
    tensors; pad rows carry epsilon 1.0, so that they never pass the
    Möller-Trumbore parallel test, and gid -1.  ``first`` is the global
    index of local shard 0 (0 when stacked), ``n_shards`` the total S,
    ``group`` the ``pr`` process group of an owned shard (None when
    stacked)."""

    v0: V3                      # components (S_local, m)
    e1: V3
    e2: V3
    n: V3
    eps: torch.Tensor           # (S_local, m) float32
    mat: torch.Tensor           # (S_local, m) int64
    gid: torch.Tensor           # (S_local, m) int64 global id, pad -1
    kt: torch.Tensor | None     # (S_local, m, 3) kt rows of transparent scenes
    transp: torch.Tensor | None  # (S_local, m) bool
    chunk: int
    n_shards: int
    first: int = 0
    group: object = None

    @property
    def m(self) -> int:
        return self.eps.shape[1]

    @property
    def n_local(self) -> int:
        return self.eps.shape[0]

    def rows(self, k: int) -> range:
        """The global triangle indices of local shard ``k`` (pad included)."""
        lo = (self.first + k) * self.m
        return range(lo, lo + self.m)


def shard_triangles(ds: G.DeviceScene, static, n_shards: int, *,
                    tri_chunk: int = 2048, owned: int | None = None,
                    group=None) -> TriShards:
    """Split the triangle arrays into ``n_shards`` contiguous ranges, by
    the JAX package's rules: the per-shard chunk C = ``tri_chunk`` /
    ``n_shards`` (at most a shard's triangles, at least 8, a multiple of
    8), and the shard length m a whole number of chunks.

    ``owned=None`` keeps all shards stacked; ``owned=k`` keeps shard k
    alone, for the rank of index k in ``group``, the ``pr`` group (given
    when there are other ranks).  Shard k is the same slice of the
    replicated tensors either way; the kt rows are gathered from
    ``materials.kt`` and stay differentiable."""
    nt = ds.tri_v0.shape[0]
    ns = static.n_spheres
    dev = ds.tri_v0.device
    if owned is not None and group is None and n_shards > 1:
        raise ValueError("shard_triangles: an owned shard needs the pr group")
    if static.n_prims >= NO_GID:
        raise ValueError(f"shard_triangles: {static.n_prims} primitives; "
                         f"the folds take fewer than {NO_GID}")
    C = max(8, -(-min(tri_chunk // n_shards, -(-nt // n_shards)) // 8) * 8)
    m = -(-max(-(-nt // n_shards), 1) // C) * C
    pad = n_shards * m - nt
    first, n_local = (0, n_shards) if owned is None else (owned, 1)
    lo, hi = first * m, (first + n_local) * m

    def phost(x, fill):
        x = np.asarray(x)
        if pad:
            x = np.concatenate(
                [x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
        return x[lo:hi].reshape((n_local, m) + x.shape[1:])

    def pdev(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
        return x[lo:hi].reshape((n_local, m) + tuple(x.shape[1:]))

    eps_np = phost(np.asarray(static.epsilon[ns:ns + nt], np.float32), 1.0)
    mat_np = phost(np.asarray(static.material_index[ns:ns + nt], np.int64),
                   0)
    gid_np = phost(np.arange(ns, ns + nt, dtype=np.int64), -1)
    transp_np = np.asarray(static.is_transparent, bool)[mat_np] & (gid_np >= 0)
    # whether any shard holds a transparent triangle: every shard then
    # packs its kt rows, so that all shards' data have one layout
    any_transp = bool(np.asarray(static.is_transparent, bool)[
        np.asarray(static.material_index[ns:ns + nt], np.int64)].any())

    def pv3(x):
        a = pdev(x, 0.0)
        return V3(a[..., 0], a[..., 1], a[..., 2])

    # the tables copied from the host
    tracing.count("sync.shard_triangles", 3 + 2 * any_transp)
    kt = transp = None
    if any_transp:
        kt = ds.materials.kt[torch.as_tensor(mat_np, device=dev)]
        transp = torch.as_tensor(transp_np, device=dev)
    return TriShards(
        v0=pv3(ds.tri_v0), e1=pv3(ds.tri_e1), e2=pv3(ds.tri_e2),
        n=pv3(ds.tri_n), eps=torch.as_tensor(eps_np, device=dev),
        mat=torch.as_tensor(mat_np, device=dev),
        gid=torch.as_tensor(gid_np, device=dev), kt=kt, transp=transp,
        chunk=C, n_shards=n_shards, first=first,
        group=group if owned is not None else None)


def stack_shards(parts: list, sh: TriShards) -> torch.Tensor:
    """Per-shard results of this process's shards, one tensor each, as
    (S, ...) in shard order: the local list stacked, or for an owned
    shard every ``pr`` rank's, gathered.  Selection data only: nothing
    that crosses ranks carries a gradient."""
    if sh.group is None:
        return torch.stack(parts)
    return comm.gather(parts[0], sh.group)


def fold_closest(data):
    """The cross-shard closest-hit fold of per-shard (S, R, 2) rows (t, gid
    as float32; t = FLT_MAX and gid = NO_GID where a shard hit nothing):
    the global min over t, ties to the lowest global id.  Returns (t, gid
    int64, found), each (R,)."""
    ts, gs = data[..., 0], data[..., 1]
    tm = ts.amin(0)
    gm = torch.where(ts == tm, gs, float(NO_GID)).amin(0)
    return tm, gm.long(), tm < FLT_MAX


def closest_row(t, gid):
    """One shard's (R, 2) closest-hit row for ``fold_closest``."""
    return torch.stack([t, gid.to(torch.float32)], -1)


@torch.no_grad()
def _shard_closest(sh: TriShards, k: int, o: V3, d: V3):
    """Local shard ``k``'s closest triangle hit: its chunks folded by the
    rule of ``primitives.closest_hit_soa`` (the first winner in a chunk,
    a later chunk only on a strictly smaller t).  Returns the (P, 2) row."""
    shape, dev = o.x.shape, o.x.device
    C = sh.chunk
    ts = torch.full(shape, FLT_MAX, dtype=torch.float32, device=dev)
    gs = torch.full(shape, NO_GID, dtype=torch.int64, device=dev)
    iota = torch.arange(C, device=dev)[:, None]
    ob, db = o.map(lambda a: a[None]), d.map(lambda a: a[None])
    for c0 in range(0, sh.m, C):
        def col(v: V3):
            return v.map(lambda a: a[k, c0:c0 + C][:, None])
        t, hit = G._mt_test_soa(ob, db, col(sh.v0), col(sh.e1), col(sh.e2),
                                sh.eps[k, c0:c0 + C][:, None])
        t = torch.where(hit, t, FLT_MAX)                      # (C, P)
        tmin = t.amin(0)
        win = (t == tmin[None]) & (t < FLT_MAX)
        first = torch.where(win, iota, C).amin(0).clamp(max=C - 1)
        better = tmin < ts
        ts = torch.where(better, tmin, ts)
        gs = torch.where(better, sh.gid[k, c0:c0 + C][first], gs)
    return closest_row(ts, gs)


def closest_hit_sharded(ds: G.DeviceScene, static, sh: TriShards, o: V3,
                        d: V3):
    """Closest hit over the whole scene with sharded triangles: the
    spheres and planes folded as in ``closest_hit_soa``, then the
    triangles' cross-shard fold, which wins only on a strictly smaller t
    (the triangles fold last there too).  Returns (t, gid, mat, normal)
    as ``closest_hit_soa`` does."""
    best = G.closest_hit_soa(ds, static, o, d, include_triangles=False)
    data = stack_shards([_shard_closest(sh, k, o, d)
                         for k in range(sh.n_local)], sh)
    return merge_closest(ds, static, best, o, d, *fold_closest(data))


def merge_closest(ds, static, best, o: V3, d: V3, t, gid, found):
    """The triangles' fold (t, gid, found) set against the sphere/plane
    pre-pass ``best`` = (t, gid, mat, normal): a triangle wins on a
    strictly smaller t.  The winner's t keeps the fold's value, bit for
    bit, and takes its gradient from the winner's Möller-Trumbore test
    formed again from the replicated triangle tables; its normal and
    material are its rows of those tables.  Lanes without a triangle
    winner test the zero ray (finite partials under a zero cotangent)."""
    bt, bg, bm, bn = best
    better = found & (t < bt)
    ns, nt = static.n_spheres, static.n_triangles
    ti = (gid - ns).clamp(0, nt - 1)
    if torch.is_grad_enabled():
        oz, dz = (v3m.where(found, v, 0.0) for v in (o, d))
        t_re, _ = G._mt_test_soa(oz, dz, *(v3m.rows(x, ti) for x in (
            ds.tri_v0, ds.tri_e1, ds.tri_e2)), ds.tri_eps[ti])
        t = t + torch.where(found, t_re - t_re.detach(), 0.0)
    mat = ds.mat_idx[gid.clamp(0, ds.mat_idx.shape[0] - 1)]
    return (torch.where(better, t, bt), torch.where(better, gid, bg),
            torch.where(better, mat, bm),
            v3m.where(better, v3m.rows(ds.tri_n, ti), bn))


def fold_counts(data, n_slots: int):
    """The cross-shard shadow fold of per-shard (S, ..., 2 + n_slots)
    int32 rows (blocked, the slot counts, the spill): (blocked, counts
    (..., n_slots) int16 or None, spill)."""
    blocked = (data[..., 0] > 0).any(0)
    counts = (data[..., 1:1 + n_slots].sum(0).to(torch.int16)
              if n_slots else None)
    return blocked, counts, data[..., -1].amax(0)


def counts_row(blocked, counts, spill):
    """One shard's int32 shadow row for ``fold_counts``."""
    cols = [blocked.to(torch.int32)[..., None]]
    if counts is not None:
        cols.append(counts.to(torch.int32))
    cols.append(torch.broadcast_to(spill, blocked.shape).to(
        torch.int32)[..., None])
    return torch.cat(cols, -1)


def any_hit_counts_sharded(ds: G.DeviceScene, static, sh: TriShards, o: V3,
                           d: V3, max_dist, exclude_gid):
    """Shadow query with sharded triangles (is_light_blocked,
    render.c:126-134): (blocked, counts) as ``any_hit_counts_soa`` returns
    them, the shards' blockers folded into the sphere/plane pre-pass."""
    blocked, counts = G.any_hit_counts_soa(ds, static, o, d, max_dist,
                                           exclude_gid,
                                           include_triangles=False)
    shape = blocked.shape
    dev = blocked.device
    slots = G.tint_slots(static)
    # the slot table and ``exclude_gid`` copied from the host
    tracing.count("sync.any_hit_tables", 1 + (
        not isinstance(exclude_gid, torch.Tensor)))
    slot_of = torch.as_tensor([slots.index(m) if tr else -1 for m, tr in
                               enumerate(static.is_transparent)],
                              device=dev)
    C = sh.chunk
    cdim = (C,) + (1,) * len(shape)

    def ex(a):
        return a.reshape(cdim)

    ob, db = o.map(lambda a: a[None]), d.map(lambda a: a[None])
    md, exg = max_dist[None], torch.as_tensor(exclude_gid, device=dev)[None]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    parts = []
    for k in range(sh.n_local):
        blk = torch.zeros(shape, dtype=torch.bool, device=dev)
        cnt = (torch.zeros(shape + (len(slots),), dtype=torch.int16,
                           device=dev) if sh.kt is not None else None)
        for c0 in range(0, sh.m, C):
            cols = slice(c0, c0 + C)
            t, hit = G._mt_test_soa(
                ob, db, sh.v0.map(lambda a: ex(a[k, cols])),
                sh.e1.map(lambda a: ex(a[k, cols])),
                sh.e2.map(lambda a: ex(a[k, cols])), ex(sh.eps[k, cols]))
            in_range = hit & (t < md) & (exg != ex(sh.gid[k, cols]))
            if cnt is None:
                blk = blk | in_range.any(0)
                continue
            tr = ex(sh.transp[k, cols])
            blk = blk | (in_range & ~tr).any(0)
            cnt = cnt + G.slot_counts(in_range & tr,
                                      ex(slot_of[sh.mat[k, cols]]),
                                      len(slots), 0)
        parts.append(counts_row(blk, cnt, zero))
    b, c, _ = fold_counts(stack_shards(parts, sh),
                          len(slots) if sh.kt is not None else 0)
    blocked = blocked | b
    if c is not None:
        counts = counts + c
    return blocked, counts

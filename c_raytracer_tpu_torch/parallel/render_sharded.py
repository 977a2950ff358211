"""Rendering on a mesh of ranks, as in
``c_raytracer_tpu.parallel.render_sharded``: pixel tiles over ``px``,
Monte-Carlo samples over ``sp``, primitive ranges over ``pr``.

The frame is tiled exactly as ``make_renderer`` tiles it
(render/api.py ``_Frame``): the same auto tile, the same tile count, and
tile ``i`` draws under the path ``(i, ...)``.  The ``px`` ranks take whole
tiles, round-robin (tile ``i`` on rank ``i mod n_px``), so every draw keeps
its index and each tile's dead-round test looks at that tile alone; a rank
with no tile idles.  With ``n_sp = 1`` the image, z and stats are bit for
bit ``make_renderer``'s.

Each ``sp`` replica renders ``samples_per_pixel // n_sp`` GI samples a
pixel under path GI (when ``spp >= n_sp``) and draws from its own
sampler; the colour is the replicas' mean, z replica 0's.  Direct light is
sampled anew by every replica, which only lowers its variance.

With ``n_pr > 1`` and triangles, each ``pr`` rank holds one contiguous
triangle range (geometry/sharded.py ``shard_triangles(owned=...)``) and
the intersector gathers the per-shard hits across the ``pr`` group.

Every rank ends with the whole frame: one all-gather over the mesh for
each output (colour, z, per-tile stats).  Stats sum over tiles and
replicas; the ``*_spill_max`` guards take the max.
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.core import comm
from c_raytracer_tpu_torch.geometry import sharded
from c_raytracer_tpu_torch.render import api
from c_raytracer_tpu_torch.render.config import GI_PATH, RenderConfig
from c_raytracer_tpu_torch.render.integrator import STAT_KEYS
from c_raytracer_tpu_torch.scene import types as T
from c_raytracer_tpu_torch.scene.convert import params_to_torch


class ShardedFrame:
    """One rank's part of a mesh frame: its tiles, its replica, its
    triangle range, and the gathers that make the whole frame."""

    def __init__(self, static, cfg: RenderConfig, resx: int, resy: int,
                 mesh, device, shards: int | None = None):
        n_px, n_sp, n_pr = mesh.shape
        if cfg.gi_model == GI_PATH and cfg.samples_per_pixel >= n_sp:
            spp_local = cfg.samples_per_pixel // n_sp
        else:
            spp_local = cfg.samples_per_pixel
        self.cfg = dataclasses.replace(cfg,
                                       samples_per_pixel=max(spp_local, 1))
        self.mesh = mesh
        if n_pr > 1 and static.n_triangles:
            if shards not in (None, n_pr):
                raise ValueError(f"shards={shards} on a mesh of {n_pr} pr "
                                 "ranks: one range a rank")

            def shard(ds):
                return sharded.shard_triangles(
                    ds, static, n_pr, tri_chunk=self.cfg.tri_chunk,
                    owned=mesh.index("pr"), group=mesh.axis_group("pr"))
        else:
            shard = api.stacked_shards(static, self.cfg, shards)
        self.frame = api._Frame(static, self.cfg, resx, resy, device, shard)
        f = self.frame
        self.mine = list(range(mesh.index("px"), f.n_tiles, n_px))
        self.per_rank = -(-f.n_tiles // n_px)

    def sampler_of(self, sampler):
        """This rank's replica sampler: the caller's with one replica; with
        more, ``sampler[sp]`` from a sequence of replica samplers, or
        ``sampler.fold_in(sp)``."""
        n_sp, sp = self.mesh.size("sp"), self.mesh.index("sp")
        if isinstance(sampler, (list, tuple)):
            if len(sampler) != n_sp:
                raise ValueError(f"{len(sampler)} replica samplers for "
                                 f"n_sp={n_sp}")
            return sampler[sp]
        return sampler if n_sp == 1 else sampler.fold_in(sp)

    def local(self, params, sampler, grad: bool, rays=None):
        """This rank's tiles: (colour (per_rank·tile, 3), z (per_rank·tile,),
        stats (per_rank, len(STAT_KEYS)) float64), zero past its last
        tile.  With ``grad`` the colour carries the graph.  ``rays``: the
        frame's padded primary (origins, directions), by default
        ``frame.rays(params)``."""
        f = self.frame
        n = self.per_rank * f.tile
        sampler = self.sampler_of(sampler)
        colors, zs, stats = [], [], []
        if self.mine:
            ix = f.intersector(params, grad)
            o, d = f.rays(params) if rays is None else rays
            for i in self.mine:
                c, z, st = f.tiles(ix, o, d, sampler, i, i + 1, True)
                colors.append(c)
                zs.append(z)
                stats.append(torch.stack([st[k] for k in STAT_KEYS]))
        dev = f.device
        pad = n - len(self.mine) * f.tile
        colors.append(torch.zeros((pad, 3), device=dev))
        zs.append(torch.zeros((pad,), device=dev))
        stats += [torch.zeros(len(STAT_KEYS), dtype=torch.float64,
                              device=dev)] * (self.per_rank - len(self.mine))
        return torch.cat(colors), torch.cat(zs), torch.stack(stats)

    def _all(self, x):
        """Every rank's ``x`` (mesh rank order), gathered over the mesh."""
        if not self.mesh.distributed:
            return x[None]
        return comm.gather(x.detach(), self.mesh.group)

    def assemble(self, color, z, stats):
        """The whole frame on every rank from each rank's ``local``
        outputs: (image (resy, resx, 3), z (resy, resx), stats dict)."""
        f, mesh = self.frame, self.mesh
        n_px, n_sp, _ = mesh.shape
        colors, zs, sts = self._all(color), self._all(z), self._all(stats)
        t = f.tile
        out_c, out_z, out_st = [], [], []
        for i in range(f.n_tiles):
            p, j = i % n_px, i // n_px
            rows = slice(j * t, (j + 1) * t)
            reps = [mesh.rank_of(p, s, 0) for s in range(n_sp)]
            c = colors[reps[0], rows]
            for r in reps[1:]:
                c = c + colors[r, rows]
            out_c.append(c if n_sp == 1 else c / n_sp)
            out_z.append(zs[reps[0], rows])
            out_st += [dict(zip(STAT_KEYS, sts[r, j].unbind()))
                       for r in reps]
        img, zimg = f.image(torch.cat(out_c), torch.cat(out_z))
        return img, zimg, api._merge_stats(out_st)

    def weight(self, g_full):
        """This rank's rows of ``g_full`` (the loss's gradient with respect
        to the whole padded frame's colour, (n_tiles·tile, 3)), laid out as
        ``local``'s colour and weighted by its share of those pixels:
        1/n_sp for a replica's part of the mean, 1/n_pr for each of the pr
        ranks that render the same pixels."""
        f = self.frame
        _, n_sp, n_pr = self.mesh.shape
        t = f.tile
        rows = [g_full[i * t:(i + 1) * t] for i in self.mine]
        rows.append(g_full.new_zeros(((self.per_rank - len(self.mine)) * t,
                                      3)))
        return torch.cat(rows) * (1.0 / (n_sp * n_pr))


def make_sharded_renderer(static: T.SceneStatic, cfg: RenderConfig,
                          resx: int, resy: int, mesh, *, device,
                          with_stats: bool = False,
                          shards: int | None = None):
    """Build ``render_fn(params, sampler) -> (image (resy, resx, 3),
    z (resy, resx))`` (plus the stats with ``with_stats``) over the ranks
    of ``mesh`` (parallel/mesh.py), on this rank's ``device``; every rank
    calls it with the same arguments and gets the whole frame, without
    gradients (``make_train_step`` takes them).

    ``sampler``: with one ``sp`` replica the caller's sampler, as
    ``make_renderer`` takes it (the same draws); with more, a sequence of
    one sampler a replica, or one sampler whose ``fold_in(s)`` is replica
    s's.  ``shards`` on a mesh without a ``pr`` axis stacks that many
    triangle ranges in each rank (as ``make_renderer``'s)."""
    sf = ShardedFrame(static, cfg, resx, resy, mesh, device, shards)

    @torch.no_grad()
    def render_fn(params, sampler):
        params = params_to_torch(params, sf.frame.device)
        img, z, st = sf.assemble(*sf.local(params, sampler, False))
        return (img, z, st) if with_stats else (img, z)

    return render_fn

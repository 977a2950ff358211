"""Top-level render API: primary rays → tiled wavefront → image, as in
``c_raytracer_tpu.render.api``.

``make_renderer`` closes over the static scene topology and the config and
returns ``render_fn(params, sampler)``; ``sampler.uniform(path, shape)``
supplies every random draw (``core.rng.PhiloxSampler`` on the render
device, or any object with that method — the tests inject the JAX
package's draws this way).  ``make_host_tiled_renderer`` and
``make_host_tiled_value_and_grad`` run the same tiles in batches from a
host loop, the second with one autograd graph a batch, so that a
gradient step's memory is bounded by one batch; ``render`` is the
one-call convenience.
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.accel.intersect import (AUTO_THRESHOLD,
                                                   make_intersector)
from c_raytracer_tpu_torch.core import remat, rng
from c_raytracer_tpu_torch.geometry import primitives as G
from c_raytracer_tpu_torch.geometry import sharded
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.render.config import RenderConfig
from c_raytracer_tpu_torch.render.integrator import render_wavefront
from c_raytracer_tpu_torch.scene import types as T
from c_raytracer_tpu_torch.scene.convert import (map_leaves, named_leaves,
                                                 params_to_torch)

DENSE_TILE = 65536   # the JAX package's auto tiles: dense scenes,
CLUSTER_TILE = 2048  # and cluster scenes (api.py:35-42 there)


def _requires_grad(params: T.SceneParams) -> bool:
    return any(x.requires_grad for _, x in named_leaves(params))


class _Frame:
    """One frame's tiling: tiles of ``cfg.tile_size`` pixels, or the auto
    tile (2048 for scenes that take the cluster sweep, 65536 otherwise),
    at most the frame, the frame padded to whole tiles.  Renders tiles of
    primary rays and stitches them."""

    def __init__(self, static, cfg, resx, resy, device, shard=None):
        self.static, self.cfg, self.resx, self.resy = static, cfg, resx, resy
        self.device = torch.device(device)
        # ds -> TriShards of the frame's triangle ranges, or None
        self.shard = shard
        self.n_pixels = resx * resy
        tile = cfg.tile_size
        if tile is None:
            cluster_scene = (static.n_triangles >= AUTO_THRESHOLD
                             and cfg.accel != "none")
            tile = CLUSTER_TILE if cluster_scene else DENSE_TILE
        self.tile = min(tile, self.n_pixels)
        self.n_tiles = -(-self.n_pixels // self.tile)
        self.pad = self.n_tiles * self.tile - self.n_pixels

    def setup(self, params, grad: bool):
        """(intersector, padded primary origins, directions) of the
        frame."""
        return (self.intersector(params, grad),) + self.rays(params)

    def intersector(self, params, grad: bool):
        """The frame's intersector; it keeps the occlusion masks for the
        backward when ``grad``, ``cfg.remat`` and ``"occlusion"`` among
        ``cfg.remat_names``."""
        ds = G.device_scene(params, self.static)
        ix = make_intersector(ds, self.static, self.cfg,
                              self.shard(ds) if self.shard else None)
        if (grad and self.cfg.remat
                and remat.OCCLUSION in self.cfg.remat_names):
            ix = dataclasses.replace(ix, saved_occlusion={})
        return ix

    def rays(self, params):
        """The padded primary origins and directions (n_tiles·tile, 3)."""
        o, d = primary_rays(params.camera, self.resx, self.resy)
        if self.pad:
            o = torch.cat([o, o.new_zeros((self.pad, 3))])
            d = torch.cat([d, d.new_zeros((self.pad, 3))])
        return o, d

    def tiles(self, ix, o, d, sampler, first, end, with_stats):
        """Render tiles ``first`` to ``end``; tile ``i`` draws under the
        path ``(i, round, ...)``.  Returns (color (n, 3), z (n,)[, stats])
        of their pixels, padding included."""
        t = self.tile
        outs = [render_wavefront(ix, self.static, self.cfg,
                                 rng.SampleKey(sampler, (i,)),
                                 o[i * t:(i + 1) * t], d[i * t:(i + 1) * t],
                                 with_stats=with_stats)
                for i in range(first, end)]
        color = torch.cat([out[0] for out in outs])
        z = torch.cat([out[1] for out in outs])
        if not with_stats:
            return color, z
        return color, z, _merge_stats([out[2] for out in outs])

    def image(self, color, z):
        n = self.n_pixels
        return (color[:n].reshape(self.resy, self.resx, 3),
                z[:n].reshape(self.resy, self.resx))


def _merge_stats(parts):
    """Stats of tiles or batches: counts sum, ``*_spill_max`` guards take
    the max."""
    return {k: (torch.stack([p[k] for p in parts]).max()
                if k.endswith("_spill_max")
                else torch.stack([p[k] for p in parts]).sum())
            for k in parts[0]}


def stacked_shards(static, cfg: RenderConfig, shards: int | None):
    """The ``_Frame`` shard function of ``shards`` triangle ranges stacked
    in this process, None for none (or a scene without triangles)."""
    if not shards or not static.n_triangles:
        return None

    def shard(ds):
        return sharded.shard_triangles(ds, static, shards,
                                       tri_chunk=cfg.tri_chunk)
    return shard


def make_renderer(static: T.SceneStatic, cfg: RenderConfig, resx: int,
                  resy: int, *, device, with_stats: bool = False,
                  shards: int | None = None):
    """Build ``render_fn(params, sampler) -> (image (resy, resx, 3),
    z (resy, resx))`` (plus a stats dict with ``with_stats``) on ``device``.

    The image is linear float32 radiance.  Pixels run in tiles of
    ``cfg.tile_size`` (auto, as in the JAX package: 2048 for scenes that
    take the cluster sweep, 65536 otherwise), the frame padded to whole
    tiles; tile ``i`` draws its samples under the path ``(i, round,
    emitter, chunk)``.  The intersector, with its cluster packs, is built
    once per frame and serves every tile.  Stats sum over tiles; the
    ``*_spill_max`` guards take the max.

    The frame is differentiable with respect to every ``SceneParams`` leaf
    that requires grad (``params_to_torch`` keeps the caller's leaves):
    the image and z then carry ``grad_fn`` and ``backward()`` fills the
    leaves' ``.grad``.  With ``cfg.remat`` the backward recomputes each
    round, light chunk and GI sample, keeping the values that
    ``cfg.remat_names`` names, by default the occlusion masks only
    (core/remat.py); without a leaf that requires grad the frame runs
    under ``torch.no_grad``.

    ``shards``: split the triangles into that many contiguous ranges,
    stacked in this process, each swept on its own and the results folded
    (geometry/sharded.py) — the frame of ``shards`` ``pr`` ranks
    (parallel/render_sharded.py) in one process."""
    frame = _Frame(static, cfg, resx, resy, device,
                   stacked_shards(static, cfg, shards))

    def render_fn(params, sampler):
        params = params_to_torch(params, frame.device)
        grad = torch.is_grad_enabled() and _requires_grad(params)
        with torch.set_grad_enabled(grad):
            ix, o, d = frame.setup(params, grad)
            out = frame.tiles(ix, o, d, sampler, 0, frame.n_tiles,
                              with_stats)
        return frame.image(*out[:2]) + out[2:]

    return render_fn


def make_host_tiled_renderer(static: T.SceneStatic, cfg: RenderConfig,
                             resx: int, resy: int, *, device,
                             tiles_per_call: int = 1,
                             with_stats: bool = False):
    """Forward renderer that renders ``tiles_per_call`` tiles at a time
    from a host loop: ``render_fn(params, sampler)`` returns what
    ``make_renderer``'s does, bit for bit at the same ``cfg.tile_size``
    (the same tiles, draws and intersector), without gradients.  Each
    batch's outputs are written into the frame before the next batch
    runs.  Stats sum across batches; the ``*_spill_max`` guards take the
    max."""
    frame = _Frame(static, cfg, resx, resy, device)

    @torch.no_grad()
    def render_fn(params, sampler):
        params = params_to_torch(params, frame.device)
        ix, o, d = frame.setup(params, False)
        n = frame.n_tiles * frame.tile
        color = o.new_empty((n, 3))
        z = o.new_empty((n,))
        parts = []
        for b0 in range(0, frame.n_tiles, tiles_per_call):
            b1 = min(b0 + tiles_per_call, frame.n_tiles)
            out = frame.tiles(ix, o, d, sampler, b0, b1, with_stats)
            color[b0 * frame.tile:b1 * frame.tile] = out[0]
            z[b0 * frame.tile:b1 * frame.tile] = out[1]
            parts += out[2:]
        image = frame.image(color, z)
        return image + (_merge_stats(parts),) if with_stats else image

    return render_fn


def make_host_tiled_value_and_grad(static: T.SceneStatic,
                                   cfg: RenderConfig, resx: int, resy: int,
                                   pixel_loss, *, device,
                                   tiles_per_call: int = 1):
    """A gradient step in tile batches: ``fn(params, sampler, target=None)
    -> (loss float, grads)``, ``grads`` a ``SceneParams`` of tensors on
    ``device``, one for each leaf.

    The loss is ``Σ pixel_loss(color (n, 3), z (n,), target_slice) (n,)``
    over the frame's pixels, ``target_slice`` the batch's rows of
    ``target`` (leading axis resy·resx pixels), or None.  Each batch of
    ``tiles_per_call`` tiles builds its own graph, the primary rays inside
    it so that camera gradients flow, masks the padded lanes of the last
    tile, runs ``backward()`` into leaves shared by every batch and frees
    its graph before the next batch: peak memory is one batch's.  The
    tiles and draws are ``make_renderer``'s, so the loss and grads equal
    its backward's up to float summation order."""
    frame = _Frame(static, cfg, resx, resy, device)

    def fn(params, sampler, target=None):
        leaves = map_leaves(params_to_torch(params, frame.device),
                            lambda x: x.detach().requires_grad_(True))
        n = frame.n_tiles * frame.tile
        if target is not None and frame.pad:
            target = torch.cat([target, target.new_zeros(
                (frame.pad,) + tuple(target.shape[1:]))])
        valid = torch.arange(n, device=frame.device) < frame.n_pixels
        loss = 0.0
        for b0 in range(0, frame.n_tiles, tiles_per_call):
            b1 = min(b0 + tiles_per_call, frame.n_tiles)
            rows = slice(b0 * frame.tile, b1 * frame.tile)
            with torch.enable_grad():
                ix, o, d = frame.setup(leaves, True)
                color, z = frame.tiles(ix, o, d, sampler, b0, b1, False)
                per_pixel = pixel_loss(
                    color, z, None if target is None else target[rows])
                loss_b = torch.where(valid[rows], per_pixel, 0.0).sum()
            loss_b.backward()
            loss += float(loss_b.detach())
        return loss, map_leaves(leaves, lambda x: (
            x.grad if x.grad is not None else torch.zeros_like(x)))

    return fn


def render(scene: T.Scene, cfg: RenderConfig, resx: int, resy: int,
           sampler=None, *, device):
    """Render a ``Scene`` bundle in one call: (image, z).  ``sampler``
    defaults to the Philox stream of seed 0 on ``device``."""
    if sampler is None:
        sampler = rng.PhiloxSampler(0, device)
    return make_renderer(scene.static, cfg, resx, resy,
                         device=device)(scene.params, sampler)

"""Top-level render API: primary rays → tiled wavefront → image, as in
``c_raytracer_tpu.render.api``.

``make_renderer`` closes over the static scene topology and the config and
returns ``render_fn(params, sampler)``; ``sampler.uniform(path, shape)``
supplies every random draw (``core.rng.PhiloxSampler`` on the render
device, or any object with that method — the tests inject the JAX
package's draws this way).
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.accel.intersect import (AUTO_THRESHOLD,
                                                   make_intersector)
from c_raytracer_tpu_torch.core import remat, rng
from c_raytracer_tpu_torch.geometry import primitives as G
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.render.config import RenderConfig
from c_raytracer_tpu_torch.render.integrator import render_wavefront
from c_raytracer_tpu_torch.scene import types as T
from c_raytracer_tpu_torch.scene.convert import named_leaves, params_to_torch

DENSE_TILE = 65536   # the JAX package's auto tiles: dense scenes,
CLUSTER_TILE = 2048  # and cluster scenes (api.py:35-42 there)


def _requires_grad(params: T.SceneParams) -> bool:
    return any(x.requires_grad for _, x in named_leaves(params))


def make_renderer(static: T.SceneStatic, cfg: RenderConfig, resx: int,
                  resy: int, *, device, with_stats: bool = False):
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
    round and light chunk, keeping only the occlusion masks
    (core/remat.py); without a leaf that requires grad the frame runs
    under ``torch.no_grad``."""
    device = torch.device(device)
    n_pixels = resx * resy
    tile = cfg.tile_size
    if tile is None:
        cluster_scene = (static.n_triangles >= AUTO_THRESHOLD
                         and cfg.accel != "none")
        tile = CLUSTER_TILE if cluster_scene else DENSE_TILE
    tile = min(tile, n_pixels)
    n_tiles = -(-n_pixels // tile)
    pad = n_tiles * tile - n_pixels

    remat.check_names(cfg.remat_names)

    def render_fn(params, sampler):
        params = params_to_torch(params, device)
        grad = torch.is_grad_enabled() and _requires_grad(params)
        with torch.set_grad_enabled(grad):
            ix = make_intersector(G.device_scene(params, static), static, cfg)
            if grad and cfg.remat:
                ix = dataclasses.replace(ix, saved_occlusion={})
            o, d = primary_rays(params.camera, resx, resy)
            if pad:
                o = torch.cat([o, o.new_zeros((pad, 3))])
                d = torch.cat([d, d.new_zeros((pad, 3))])
            outs = [render_wavefront(ix, static, cfg,
                                     rng.SampleKey(sampler, (i,)),
                                     o[i * tile:(i + 1) * tile],
                                     d[i * tile:(i + 1) * tile],
                                     with_stats=with_stats)
                    for i in range(n_tiles)]
        color = torch.cat([out[0] for out in outs])[:n_pixels]
        z = torch.cat([out[1] for out in outs])[:n_pixels]
        image = (color.reshape(resy, resx, 3), z.reshape(resy, resx))
        if not with_stats:
            return image
        stats = {k: torch.stack([out[2][k] for out in outs])
                 for k in outs[0][2]}
        stats = {k: (v.max() if k.endswith("_spill_max") else v.sum())
                 for k, v in stats.items()}
        return image + (stats,)

    return render_fn


def make_host_tiled_renderer(*args, **kwargs):
    raise NotImplementedError(
        "host-tiled renders are not ported yet (ROADMAP: long renders)")


def make_host_tiled_value_and_grad(*args, **kwargs):
    raise NotImplementedError(
        "host-tiled value-and-grad is not ported yet (ROADMAP: long renders)")

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

from c_raytracer_tpu_torch.core import rng
from c_raytracer_tpu_torch.geometry import primitives as G
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.render.config import RenderConfig
from c_raytracer_tpu_torch.render.integrator import render_wavefront
from c_raytracer_tpu_torch.scene import types as T
from c_raytracer_tpu_torch.scene.convert import params_to_torch

DENSE_TILE = 65536   # the JAX package's auto tile for dense scenes


def _requires_grad(params: T.SceneParams) -> bool:
    leaves = [getattr(params, f.name) for f in dataclasses.fields(params)]
    leaves += [getattr(params.materials, f.name)
               for f in dataclasses.fields(params.materials)]
    leaves += [getattr(params.camera, f.name)
               for f in dataclasses.fields(params.camera)]
    return any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in leaves)


def make_renderer(static: T.SceneStatic, cfg: RenderConfig, resx: int,
                  resy: int, *, device, with_stats: bool = False):
    """Build ``render_fn(params, sampler) -> (image (resy, resx, 3),
    z (resy, resx))`` (plus a stats dict with ``with_stats``) on ``device``.

    The image is linear float32 radiance.  Pixels run in tiles of
    ``cfg.tile_size`` (auto: 65536, the JAX package's dense-scene tile),
    the frame padded to whole tiles; tile ``i`` draws its samples under the
    path ``(i, round, emitter, chunk)``.  Stats sum over tiles; the
    ``*_spill_max`` guards take the max."""
    device = torch.device(device)
    n_pixels = resx * resy
    tile = min(cfg.tile_size or DENSE_TILE, n_pixels)
    n_tiles = -(-n_pixels // tile)
    pad = n_tiles * tile - n_pixels

    def render_fn(params, sampler):
        params = params_to_torch(params, device)
        if _requires_grad(params):
            raise NotImplementedError(
                "gradients through the frame are not ported yet (ROADMAP: "
                "gradients through the main path)")
        with torch.no_grad():
            ds = G.device_scene(params, static)
            o, d = primary_rays(params.camera, resx, resy)
            if pad:
                o = torch.cat([o, o.new_zeros((pad, 3))])
                d = torch.cat([d, d.new_zeros((pad, 3))])
            outs = [render_wavefront(ds, static, cfg,
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

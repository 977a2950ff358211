"""The training step on a mesh of ranks, as in
``c_raytracer_tpu.parallel.train``: every ``SceneParams`` leaf is a
weight, the loss is ``mean((img − target)²)`` over the whole frame, and
plain SGD updates the leaves.

The gradient is that of the one-process loss.  Every rank renders its
part (parallel/render_sharded.py ``ShardedFrame``), the whole frame is
gathered without gradient, and each rank computes the loss and its
gradient with respect to the frame's colour, alike on every rank.  Each
rank then backs up its own share: its own tiles, 1/n_sp of its replica's
part of the mean, 1/n_pr of the pixels its ``pr`` group renders alike (the
gathers inside the intersector sum the group's cotangents of each rank's
shard, core/comm.py).  One all-reduce of every leaf's gradient and of the
primary rays' cotangents, flattened into one tensor, sums the shares over
the mesh; the camera's gradient is then backed up from the summed rays on
every rank alike, so that it sums the frame's pixels in the one-process
order.  Every rank takes the same step.
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.core import comm
from c_raytracer_tpu_torch.parallel.render_sharded import ShardedFrame
from c_raytracer_tpu_torch.render.config import RenderConfig
from c_raytracer_tpu_torch.scene import types as T
from c_raytracer_tpu_torch.scene.convert import (map_leaves, named_leaves,
                                                 params_to_torch)

_CAMERA = ("position", "vector_x", "vector_y", "fov", "focal_length")


def loss_and_grad_fn(static: T.SceneStatic, cfg: RenderConfig, resx: int,
                     resy: int, mesh, *, device, shards: int | None = None):
    """``fn(params, sampler, target) -> (loss, grads)``: the loss a 0-d
    tensor and the grads a ``SceneParams`` of tensors, one a leaf, equal
    on every rank.  ``target`` (resy, resx, 3); ``sampler`` and ``shards``
    as ``make_sharded_renderer`` takes them."""
    sf = ShardedFrame(static, cfg, resx, resy, mesh, device, shards)
    f = sf.frame

    def fn(params, sampler, target):
        leaves = map_leaves(params_to_torch(params, f.device),
                            lambda x: x.detach().requires_grad_(True))
        with torch.enable_grad():
            # the primary rays are the frame's, alike on every rank: their
            # per-pixel cotangents are summed over the mesh (each pixel's
            # comes from the ranks that render it) before the camera's
            # backward, so the camera's grads sum their pixels in the
            # one-process order
            rays = f.rays(leaves)
            rays_in = tuple(r.detach().requires_grad_(True) for r in rays)
            color, z, stats = sf.local(leaves, sampler, True, rays_in)
        img, _, _ = sf.assemble(color.detach(), z, stats)
        img = img.requires_grad_(True)
        target = torch.as_tensor(target, dtype=torch.float32,
                                 device=f.device)
        with torch.enable_grad():
            loss = torch.mean((img - target) ** 2)
            (g_img,) = torch.autograd.grad(loss, img)
        g_full = torch.cat([g_img.reshape(-1, 3), g_img.new_zeros(
            (f.n_tiles * f.tile - f.n_pixels, 3))])
        if sf.mine:
            # every rank with tiles runs its backward; an idle rank's
            # shares are zero (its pr group is idle alike)
            (color * sf.weight(g_full)).sum().backward()
        grads = map_leaves(leaves, lambda x: (
            x.grad if x.grad is not None else torch.zeros_like(x)))
        ray_grads = [r.grad if r.grad is not None else torch.zeros_like(r)
                     for r in rays_in]
        if mesh.distributed:
            _all_reduce_sum([g for _, g in named_leaves(grads)] + ray_grads,
                            mesh.group)
        cam = [getattr(leaves.camera, k) for k in _CAMERA]
        g_cam = torch.autograd.grad(rays, cam, ray_grads, allow_unused=True)
        camera = dataclasses.replace(grads.camera, **{
            k: getattr(grads.camera, k) + g
            for k, g in zip(_CAMERA, g_cam) if g is not None})
        return loss.detach(), dataclasses.replace(grads, camera=camera)

    return fn


def _all_reduce_sum(tensors, group) -> None:
    """Sum each of ``tensors`` over ``group`` in one all-reduce of them
    flattened into one tensor, and write the sums back in place."""
    flat = torch.cat([g.reshape(-1) for g in tensors])
    comm.all_reduce_sum(flat, group)
    i = 0
    for g in tensors:
        g.copy_(flat[i:i + g.numel()].reshape(g.shape))
        i += g.numel()


def make_train_step(static: T.SceneStatic, cfg: RenderConfig, resx: int,
                    resy: int, mesh, *, device, learning_rate: float = 1e-2,
                    with_grads: bool = False, shards: int | None = None):
    """Build ``step(params, sampler, target) -> (new_params, loss)``, with
    ``with_grads`` also the gradient ``SceneParams``: plain SGD, ``p −
    learning_rate·g`` on every leaf, the same on every rank."""
    lag = loss_and_grad_fn(static, cfg, resx, resy, mesh, device=device,
                           shards=shards)

    def step(params, sampler, target):
        loss, grads = lag(params, sampler, target)
        params = params_to_torch(params, grads.sphere_center.device)
        g_of = {id(p): g for (_, p), (_, g) in zip(named_leaves(params),
                                                   named_leaves(grads))}
        new = map_leaves(params, lambda p: (
            p.detach() - learning_rate * g_of[id(p)]))
        return (new, loss, grads) if with_grads else (new, loss)

    return step

"""Image-plane geometry and primary ray generation, as in
``c_raytracer_tpu.render.camera``.

Replicates image_init (image.c:34-56) and the primary loop's pixel walk
(render.c:352-366), including the reference's one-pixel X offset quirk:
pixel (col, row) sits at ``corner + (col+1)·vx + row·vy``.
"""

from __future__ import annotations

import torch

from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import PI, sqrt
from c_raytracer_tpu_torch.scene.types import Camera


def image_plane(camera: Camera, resx: int, resy: int):
    """Returns (corner, vx, vy): the pixel-grid basis (image.c:42-55)."""
    vz = torch.stack(v3m.cross(v3m.splat(camera.vector_x),
                               v3m.splat(camera.vector_y)))  # camera.c:32
    # PI / 360 rounds to the float32 quotient the JAX package computes
    size_x = 2.0 * camera.focal_length * torch.tan(camera.fov * (PI / 360.0))
    size_y = size_x * (resy / resx)
    vx = camera.vector_x * (size_x / resx)
    vy = camera.vector_y * (size_y / resy)
    plane_center = camera.position + vz * camera.focal_length
    corner = (plane_center
              + vx * (0.5 - resx / 2.0)
              + vy * (0.5 - resy / 2.0))
    return corner, vx, vy


def primary_rays(camera: Camera, resx: int, resy: int):
    """Primary ray origins/directions for the full image, row-major.

    Returns (origins, dirs) of shape (resy*resx, 3) on the camera's device;
    origins are the camera position, dirs normalized."""
    corner, vx, vy = image_plane(camera, resx, resy)
    dev = corner.device
    cols = torch.arange(1, resx + 1, dtype=torch.float32, device=dev)  # +1
    rows = torch.arange(resy, dtype=torch.float32, device=dev)
    px = corner + cols[None, :, None] * vx + rows[:, None, None] * vy
    rel = px - camera.position
    # x² + y² + z² summed left to right, as the JAX package's norm does
    # (torch.sum over the last axis adds in another order)
    x, y, z = rel.unbind(-1)
    d = rel / sqrt(x * x + y * y + z * z)[..., None]
    o = camera.position.expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)

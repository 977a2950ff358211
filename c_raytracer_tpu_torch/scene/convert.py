"""The weights bridge: scene parameters as float32 tensors on a device.

``params_to_torch`` takes any object with the ``SceneParams`` attribute
names — this package's (NumPy leaves from the loader, or tensors already)
or the JAX package's (its leaves are host NumPy until jit, see
``c_raytracer_tpu/scene/types.py``) — and returns this package's
``SceneParams`` with every leaf a float32 tensor on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from c_raytracer_tpu_torch.scene import types as T

_MATERIAL_FIELDS = ("ks", "ka", "kr", "kt", "ke", "shininess",
                    "refractive_index", "tex_color", "tex_color2",
                    "tex_scale", "tex_p1", "tex_p2")
_CAMERA_FIELDS = ("position", "vector_x", "vector_y", "fov", "focal_length")
_PARAM_FIELDS = ("sphere_center", "sphere_radius", "tri_vertices",
                 "plane_normal", "plane_d", "ambient")


def _leaf(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def params_to_torch(params, device) -> T.SceneParams:
    """SceneParams-shaped object -> ``T.SceneParams`` of tensors on device."""
    device = torch.device(device)
    mats = T.Materials(**{f: _leaf(getattr(params.materials, f), device)
                          for f in _MATERIAL_FIELDS})
    cam = T.Camera(**{f: _leaf(getattr(params.camera, f), device)
                      for f in _CAMERA_FIELDS})
    return T.SceneParams(
        materials=mats, camera=cam,
        **{f: _leaf(getattr(params, f), device) for f in _PARAM_FIELDS})

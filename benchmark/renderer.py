"""The port's ``make_renderer`` entry for a cell, and what the reference
takes from the same cell's files.  The frame and step runners share it; a
runner of another entry brings its own."""

from __future__ import annotations

import os


class Program:
    """The system under test: the port's renderer of the cell's scene at
    the traffic's resolution, with the configuration's and the traffic's
    render flags."""

    def __init__(self, cell, device: str):
        import torch
        from c_raytracer_tpu_torch.accel import reorder_scene
        from c_raytracer_tpu_torch.core import rng
        from c_raytracer_tpu_torch.render.api import make_renderer
        from c_raytracer_tpu_torch.render.config import RenderConfig
        from c_raytracer_tpu_torch.scene.convert import (named_leaves,
                                                         params_to_torch)
        from c_raytracer_tpu_torch.scene.loader import load_scene

        self.torch, self.rng, self.device = torch, rng, device
        tr = cell.traffic
        scene = load_scene(cell.config_path)
        if cell.config.get("reorder"):
            scene = reorder_scene(scene)
        cfg = RenderConfig(**{**cell.config.get("render", {}),
                              **tr.get("render", {})})
        self.res = int(tr["resolution"])
        self.render_fn = make_renderer(scene.static, cfg, self.res, self.res,
                                       device=device)
        self.params = params_to_torch(scene.params, device)
        self.leaves = dict(named_leaves(self.params))

    def frame(self, seed: int, params=None):
        return self.render_fn(self.params if params is None else params,
                              self.rng.PhiloxSampler(seed, self.device))

    def sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()


def root_of(cell) -> str:
    """The checkout that holds the cell's configuration file."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        cell.config_path)))


def reference_flags(cell):
    from benchmark import reference
    kw = {**cell.config.get("render", {}),
          **cell.traffic.get("render", {})}
    return reference.Flags(**{k: v for k, v in kw.items()
                              if k in reference.Flags.__dataclass_fields__})


def reference_frame(cell, seed_i: int, device, dtype, shade_dtype=None):
    """The reference's frame of the cell under the draws of ``seed_i``."""
    from benchmark import reference
    scene = reference.load(cell.config_path, root=root_of(cell))
    res = int(cell.traffic["resolution"])
    return reference.render(scene, reference.device_leaves(
        scene, device, dtype), reference_flags(cell), res, res, seed_i,
        device=device, dtype=dtype, shade_dtype=shade_dtype)

"""Scene intersector, as in ``c_raytracer_tpu.accel.intersect`` — dense
route only.

Spheres and planes are always swept densely; the cluster sweep for mesh
scenes (and its Pallas visit-order kernel, accel/pallas_visit.py in the JAX
package) is not ported yet, and ``device_scene`` refuses triangles, so the
dense sweep here is exhaustive and its spill counters are 0.
"""

from __future__ import annotations

import dataclasses

import torch

from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.geometry import primitives as G


@dataclasses.dataclass(frozen=True)
class Intersector:
    """Query object used by the integrator and shading."""

    ds: G.DeviceScene
    static: object
    cfg: object

    def closest(self, o: V3, d: V3):
        """(t, gid, mat, normal V3, spill) over the whole scene; o/d V3 of
        (P,).  ``spill`` is the per-lane visit truncation count of the JAX
        package's ``closest(with_spill=True)``: 0, the dense sweep is
        exhaustive."""
        out = G.closest_hit_soa(self.ds, self.static, o, d)
        return out + (torch.zeros_like(out[1]),)


def make_intersector(ds: G.DeviceScene, static, cfg) -> Intersector:
    return Intersector(ds=ds, static=static, cfg=cfg)

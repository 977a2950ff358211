"""Render configuration — the reference's CLI flag surface (main.c:35-53,
render.c:61-116) as a static dataclass.

The same fields and defaults as ``c_raytracer_tpu.render.config``: -b 10,
-a 0.01, -s phong, -g ambient, -n 1, -l sqr, -o 1.  The execution-shape
knobs of the JAX package are accepted so one config drives both packages;
the ones that select a path this port does not have yet are rejected where
that path would be taken (see render/integrator.py).
"""

from __future__ import annotations

import dataclasses

REFLECTION_PHONG = "phong"
REFLECTION_BLINN = "blinn"
GI_AMBIENT = "ambient"
GI_PATH = "path"
ATTEN_NONE = "none"
ATTEN_LINEAR = "lin"
ATTEN_SQUARE = "sqr"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    max_bounces: int = 10                  # -b (render.c:54)
    min_light_intensity: float = 0.01      # -a; compared squared (render.c:55)
    reflection_model: str = REFLECTION_PHONG   # -s
    gi_model: str = GI_AMBIENT             # -g
    samples_per_pixel: int = 1             # -n (path-GI primary samples only)
    light_attenuation: str = ATTEN_SQUARE  # -l
    attenuation_offset: float = 1.0        # -o (render.c:52)

    # execution shape (no reference equivalent)
    rounds: int | None = None       # wavefront rounds; None -> max_bounces+1
    stack_size: int = 8             # per-pixel ray stack (stack integrator)
    tile_size: int | None = None    # pixels per wavefront tile; None -> auto
    light_chunk: int = 40           # soft-shadow samples per chunk
    gi_chunk: int = 1
    tri_chunk: int = 2048
    gi_sample_offset: int = 0
    gi_chunk_weight: int = 1
    remat: bool = True
    remat_names: tuple = ("occlusion",)

    # acceleration-structure knobs (mesh scenes; not ported yet)
    accel: str = "auto"
    bvh_cluster: int = 16
    bvh_visits: int | None = None
    bvh_shadow_visits: int | None = None
    bvh_shadow_shortlist: int | None = None
    bvh_ray_chunk: int = 32768
    bvh_super_group: int | None = None
    bvh_super_sel: int = 16

    # The JAX package's opt-in for its fused Pallas shadow kernel.  Ignored
    # here: on CUDA the fused kernel (render/fused_shadow.py) IS the
    # direct-light path of every scene it can serve.
    fused_shadow: str = "off"

    shadow_mode: str = "auto"
    union_scope: str = "auto"
    union_compact: str = "auto"
    closest_compact: str = "off"
    sweep_dead_skip: str = "auto"
    pallas_visit: str = "off"
    bvh_shadow_cluster: int | None = None

    @property
    def min_light_intensity_sqr(self) -> float:
        return self.min_light_intensity * self.min_light_intensity

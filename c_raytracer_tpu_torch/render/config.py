"""Render configuration — the reference's CLI flag surface (main.c:35-53,
render.c:61-116) as a static dataclass.

The same fields and defaults as ``c_raytracer_tpu.render.config``: -b 10,
-a 0.01, -s phong, -g ambient, -n 1, -l sqr, -o 1.  The execution-shape
knobs of the JAX package are accepted so one config drives both packages,
and each takes the path it takes there, apart from the two opt-ins of its
Pallas kernels, which the CUDA kernels serve whatever they say.
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

    # acceleration structure (accel/): "auto" | "none" | "cluster"; auto
    # takes the cluster sweep from accel.intersect.AUTO_THRESHOLD triangles
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
    # The JAX package's opt-in for its Pallas visit-order kernel.  Accepted
    # with every value and ignored: on CUDA the visit-order kernel
    # (accel/pallas_visit.py) IS the visit order (both give the same lists).
    pallas_visit: str = "off"
    bvh_shadow_cluster: int | None = None

    # The scene-aware auto policies, as the JAX package resolves them
    # (its config.py notes the measurements behind each default).

    def resolved_super_group(self, any_transparent: bool,
                             n_clusters: int) -> int:
        if self.bvh_super_group is not None:
            return self.bvh_super_group
        return 0

    def resolved_shadow_mode(self, any_transparent: bool) -> str:
        if self.shadow_mode != "auto":
            return self.shadow_mode
        return "union" if any_transparent else "shared"

    def resolved_shadow_cluster(self, any_transparent: bool) -> int:
        if self.bvh_shadow_cluster is not None:
            return self.bvh_shadow_cluster
        if self.resolved_shadow_mode(any_transparent) == "union":
            return 64
        return self.bvh_cluster

    def resolved_union_visits(self, any_transparent: bool) -> int:
        if self.bvh_shadow_visits is not None:
            return self.bvh_shadow_visits
        return 192

    def resolved_visits(self, any_transparent: bool) -> int:
        """Closest-hit visit budget: 16 for opaque scenes, 64 for
        transparent ones (rays inside a mesh see many zero-entry
        clusters)."""
        if self.bvh_visits is not None:
            return self.bvh_visits
        return 64 if any_transparent else 16

    def resolved_shadow_visits(self, any_transparent: bool) -> int:
        """Shadow visit budget: the closest-hit budget for opaque scenes,
        at least 64 for transparent ones (the kt product needs every
        blocker along the segment)."""
        if self.bvh_shadow_visits is not None:
            return self.bvh_shadow_visits
        return max(self.resolved_visits(any_transparent), 64) \
            if any_transparent else self.resolved_visits(any_transparent)

    def resolved_shadow_shortlist(self, any_transparent: bool) -> int:
        """Per-pixel triangle shortlist of the shared shadow sweep: 32 for
        opaque scenes, 0 (off) for transparent ones (nearest-to-origin
        scoring would drop kt factors)."""
        if self.bvh_shadow_shortlist is not None:
            return self.bvh_shadow_shortlist
        return 0 if any_transparent else 32

    @property
    def min_light_intensity_sqr(self) -> float:
        return self.min_light_intensity * self.min_light_intensity

    def resolved_rounds(self, any_transparent: bool) -> int:
        """Upper bound on the rounds of the reflect/refract tree."""
        if self.rounds is not None:
            return self.rounds
        if any_transparent:
            return 4 * self.max_bounces + 1
        return self.max_bounces + 1

"""The union shadow route against ``per_ray`` on the glass stand-in: the
counterpart of ``tools/profiling/s5_union_bench.py``.

    python -m c_raytracer_tpu_torch.tools.s5_union_bench [res] [max_lights]
        [configs] [--scene FILE] [--device cuda|cpu]

Defaults 64 100 and all four configs; ``configs`` is a comma-separated
subset of ``union_c128,union_c64,union_c32,per_ray`` in the order to run.
Each config renders the frame twice through ``make_host_tiled_renderer``
with every emitter capped at ``max_lights`` samples; the line gives the
second frame's seconds, the first call's seconds and the total radiance,
and for every config after the first its max |Δ| against the first
config's frame and that over the first frame's max.

The configs are the JAX script's, field for field.  Its label
``union_c128`` is stale: ``RenderConfig(shadow_mode="union")`` resolves
its shadow clusters to 64 triangles (``RenderConfig.
resolved_shadow_cluster``), so ``union_c128`` and ``union_c64`` run the
same configuration and the pair's seconds give the call's own noise.

The draws are ``PhiloxSampler(0)``'s, where the JAX script has
``PRNGKey(0)``.  The scene defaults to ``scenes/meshes_glass.json``, the
in-repo stand-in for scene5; the header names the scene file where the
JAX script says "scene5".  It runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_host_tiled_renderer
from c_raytracer_tpu_torch.tools import s5_common
from c_raytracer_tpu_torch.tools.flagship_s5 import cap_lights

CONFIGS = {
    "union_c128": RenderConfig(shadow_mode="union"),
    "union_c64": RenderConfig(shadow_mode="union", bvh_shadow_cluster=64),
    "union_c32": RenderConfig(shadow_mode="union", bvh_shadow_cluster=32),
    "per_ray": RenderConfig(shadow_mode="per_ray"),
}


def run(scene, res: int = 64, max_lights: int = 100, which=None, *,
        name: str = "scene", sampler=None, device, out=None):
    """Render each config of ``which`` (default all) twice at ``res``².

    Returns (records, lines): a record a config (its name, the shadow
    mode and shadow cluster size it resolved, both calls' seconds, the
    total radiance and, after the first, max |Δ| and rel) and the JAX
    script's lines, each also passed to ``out`` as it is made."""
    sampler = sampler or PhiloxSampler(0, device)
    lines, records = [], []

    def emit(line):
        lines.append(line)
        if out is not None:
            out(line)

    scene = cap_lights(scene, max_lights)
    static = scene.static
    any_transp = any(static.is_transparent)
    emit(f"{name} {res}x{res}, lights capped {max_lights}, "
         f"{static.n_triangles} tris")
    ref_img = None
    for cfg_name in which or list(CONFIGS):
        cfg = CONFIGS[cfg_name]
        fn = make_host_tiled_renderer(static, cfg, res, res, device=device)
        t0 = s5_common.clock(device)
        img, _ = fn(scene.params, sampler)
        t_first = s5_common.clock(device) - t0
        t0 = s5_common.clock(device)
        img, _ = fn(scene.params, sampler)
        dt = s5_common.clock(device) - t0
        img = np.asarray(img.cpu())
        tot = float(np.sum(img))
        rec = {"config": cfg_name,
               "shadow_mode": cfg.resolved_shadow_mode(any_transp),
               "shadow_cluster": cfg.resolved_shadow_cluster(any_transp),
               "seconds": dt, "first_seconds": t_first,
               "total_radiance": tot}
        line = (f"{cfg_name:12s}: {dt:8.3f} s/frame (first {t_first:.1f}s) "
                f"total radiance {tot:.4f}")
        if ref_img is None:
            ref_img = img
        else:
            d = np.abs(img - ref_img)
            rel = d.max() / max(ref_img.max(), 1e-9)
            rec.update(max_abs_diff=float(d.max()), rel=float(rel))
            line += f"  max|Δ| vs first {d.max():.2e} (rel {rel:.2e})"
        records.append(rec)
        emit(line)
    return records, lines


def main(argv=None) -> int:
    ap = s5_common.parser(__doc__)
    ap.add_argument("res", type=int, nargs="?", default=64)
    ap.add_argument("max_lights", type=int, nargs="?", default=100)
    ap.add_argument("configs", nargs="?", default=None)
    args = ap.parse_args(argv)
    device = s5_common.open_device("s5_union_bench", args.device)
    which = args.configs.split(",") if args.configs else None
    run(s5_common.load(args.scene), args.res, args.max_lights, which,
        name=os.path.basename(args.scene), device=device,
        out=lambda line: print(line, flush=True))
    s5_common.print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())

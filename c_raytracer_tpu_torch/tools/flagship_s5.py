"""The BASELINE flagship config end to end on the port: the counterpart of
``tools/flagship_s5.py`` (BASELINE.json configs[4]: scene5, a glass
dragon-class mesh of ~100k triangles, path-traced global illumination at
256 spp, differentiable materials).

    python -m c_raytracer_tpu_torch.tools.flagship_s5 [res] [spp] [lights]
        [train_res] [chunks] [--scene FILE] [--device cuda|cpu]
        [--steps N] [--forward-only]

Defaults 64 256 100 24 4 (chunks default to spp // 64, at least 1).  The
scene defaults to ``scenes/meshes_glass.json``, an in-repo STAND-IN for
scene5 (the dragon in glass over an opaque sphere and a checkerboard
plane, 100 light samples), which is not in the repository.

Two phases, each one JSON line with the JAX tool's keys:

1. **forward** — the scene in Morton order with every emitter capped at
   ``lights`` samples, rendered by ``render_spp_chunked`` in ``chunks``
   passes of ``spp / chunks`` path-GI samples, each pass host-tiled
   (tiles of 512, ``bvh_visits=104``, ``bvh_shadow_visits=288``: the JAX
   tool's config, field for field; the draws are keyed by tile, so
   another tile size is another image).  The image must be finite; the
   line carries the spill maxima and the traced rays.
2. **train** — path GI at 4 spp, light chunks of 8, lights capped at
   ``min(lights, 24)``: a target frame at the glass material's ``kt`` set
   to (0.6, 0.6, 0.9) (``make_host_tiled_renderer``), then six
   (``--steps``) SGD steps ``kt -= TRAIN_LR · ∂loss/∂kt`` through
   ``make_host_tiled_value_and_grad`` with the per-pixel loss
   Σ(colour − target)².  The loss must fall.  ``--forward-only`` stops
   after phase 1.

The step ``TRAIN_LR`` is 0.02, not the JAX tool's 200: that was set for
scene5, whose loss at 24² starts at 2.52e-5.  The stand-in's glass fills
more of the frame: at 24² its loss starts at 1.13 with ∂loss/∂kt 5.9 on
red and green, a step of 200 sends kt to -1189 and the frame to inf, and
a step of 0.02 takes the loss to 0.234 (on the CPU).

The glass material is the first with ``kt > 0`` (scene5's is material 1;
the stand-in's, id 5, is material 3); the tool names it on stderr.
``PhiloxSampler`` seeds 0 (forward) and 1 (train) stand where the JAX tool
has ``PRNGKey(0)`` and ``PRNGKey(1)``.  It runs on the card unless
``--device cpu`` is given; there is no fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import (RenderConfig,
                                          make_host_tiled_renderer,
                                          make_host_tiled_value_and_grad,
                                          render_spp_chunked)
from c_raytracer_tpu_torch.scene import load_scene, params_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_SCENE = os.path.join(ROOT, "scenes", "meshes_glass.json")
KT_TARGET = (0.6, 0.6, 0.9)
TRAIN_STEPS = 6
TRAIN_LR = 0.02


def cap_lights(scene, nl: int):
    lights = tuple(min(n, nl) for n in scene.static.num_lights)
    return dataclasses.replace(
        scene, static=dataclasses.replace(scene.static, num_lights=lights))


def forward_config(spp: int) -> RenderConfig:
    """The forward phase's config: path GI at ``spp``, tiles of 512 and
    the guard-derived visit budgets of the JAX tool."""
    return RenderConfig(gi_model="path", samples_per_pixel=spp,
                        tile_size=512, bvh_shadow_visits=288,
                        bvh_visits=104)


def train_config() -> RenderConfig:
    return RenderConfig(gi_model="path", samples_per_pixel=4, light_chunk=8)


def glass_material(params) -> int:
    """Index of the first material with a nonzero ``kt``."""
    kt = torch.as_tensor(params.materials.kt).detach().cpu().numpy()
    glass = np.flatnonzero((kt > 0).any(-1))
    if not glass.size:
        raise ValueError("the scene has no transparent material (kt > 0)")
    return int(glass[0])


def pixel_loss(color, z, target):
    return ((color - target) ** 2).sum(-1)


def forward(scene, cfg: RenderConfig, res: int, chunks: int, sampler, *,
            device, log=None):
    """Phase 1: (image, z, stats, seconds) of ``render_spp_chunked``,
    host-tiled (its frames end on the host, so the seconds hold the
    device's work)."""
    t0 = time.perf_counter()
    img, z, stats = render_spp_chunked(
        scene, cfg, res, res, sampler, device=device, spp_chunks=chunks,
        host_tiled=True, with_stats=True, log=log)
    return img, z, stats, time.perf_counter() - t0


def forward_line(img, stats, seconds, res, spp, lights, chunks) -> dict:
    return {
        "phase": "forward", "res": res, "spp": spp, "lights": lights,
        "spp_chunks": chunks,
        "seconds": round(seconds, 2), "total_radiance": float(np.sum(img)),
        "mean_radiance": float(np.mean(img)),
        "shadow_spill_max": stats.get("shadow_spill_max", 0.0),
        "visit_spill_max": stats.get("visit_spill_max", 0.0),
        "total_rays": stats.get("main_rays", 0.0)
        + stats.get("shadow_rays", 0.0) + stats.get("gi_rays", 0.0),
    }


def train(scene, cfg: RenderConfig, res: int, sampler, *, device,
          steps: int = TRAIN_STEPS) -> dict:
    """Phase 2: a target frame at the glass material's ``KT_TARGET``, then
    ``steps`` SGD steps on ``kt``.  Returns each step's loss and the glass
    kt after it (both read on the host, so the seconds hold the device's
    work), the glass index, kt at the start, target and end, and the
    steps' seconds."""
    params = params_to_torch(scene.params, device)
    g = glass_material(params)
    kt0 = params.materials.kt.detach().clone()
    kt_t = kt0.clone()
    kt_t[g] = torch.tensor(KT_TARGET, dtype=kt0.dtype, device=kt0.device)
    target_params = dataclasses.replace(
        params, materials=dataclasses.replace(params.materials, kt=kt_t))
    tfwd = make_host_tiled_renderer(scene.static, cfg, res, res,
                                    device=device)
    target = tfwd(target_params, sampler)[0].reshape(-1, 3)

    vg = make_host_tiled_value_and_grad(scene.static, cfg, res, res,
                                        pixel_loss, device=device)
    losses, kts = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, grads = vg(params, sampler, target=target)
        losses.append(loss)
        params = dataclasses.replace(params, materials=dataclasses.replace(
            params.materials,
            kt=params.materials.kt - TRAIN_LR * grads.materials.kt))
        kts.append(params.materials.kt[g].detach().cpu())
    return {"losses": losses, "kts": kts, "glass": g,
            "kt_start": kt0[g].cpu(), "kt_target": kt_t[g].cpu(),
            "kt_end": kts[-1], "seconds": time.perf_counter() - t0}


def train_line(out: dict, res: int, spp: int) -> dict:
    losses = [round(loss, 8) for loss in out["losses"]]
    return {
        "phase": "train", "res": res, "spp": spp,
        "steps": len(losses), "seconds": round(out["seconds"], 2),
        "losses": losses,
        "kt_start": [round(float(x), 3) for x in out["kt_start"]],
        "kt_target": [round(float(x), 3) for x in out["kt_target"]],
        "kt_end": [round(float(x), 3) for x in out["kt_end"]],
        "loss_reduced": bool(losses[-1] < losses[0]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("res", type=int, nargs="?", default=64)
    ap.add_argument("spp", type=int, nargs="?", default=256)
    ap.add_argument("lights", type=int, nargs="?", default=100)
    ap.add_argument("train_res", type=int, nargs="?", default=24)
    ap.add_argument("chunks", type=int, nargs="?", default=None)
    ap.add_argument("--scene", default=DEFAULT_SCENE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS,
                    help="SGD steps of phase 2")
    ap.add_argument("--forward-only", action="store_true",
                    help="run phase 1 only")
    args = ap.parse_args(argv)
    chunks = (args.chunks if args.chunks is not None
              else max(1, args.spp // 64))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flagship_s5: no CUDA device (pass --device cpu)")

    def log(m, *a):
        print(m % a, file=sys.stderr, flush=True)

    scene = cap_lights(reorder_scene(load_scene(args.scene)), args.lights)
    print(f"{os.path.basename(args.scene)}: {scene.static.n_triangles} "
          f"tris, lights capped {args.lights}, spp {args.spp} as {chunks} "
          f"chunks, device {device}", file=sys.stderr)

    # ---- phase 1: path-traced forward at full spp, host-tiled ---------
    img, _, stats, secs = forward(
        scene, forward_config(args.spp), args.res, chunks,
        PhiloxSampler(0, device), device=device, log=log)
    assert np.all(np.isfinite(img))
    print(json.dumps(forward_line(img, stats, secs, args.res, args.spp,
                                  args.lights, chunks)), flush=True)
    if args.forward_only:
        return 0

    # ---- phase 2: differentiable materials, host-tiled grads ---------
    tcfg = train_config()
    tscene = cap_lights(scene, min(args.lights, 24))
    out = train(tscene, tcfg, args.train_res, PhiloxSampler(1, device),
                device=device, steps=args.steps)
    log("glass material: %d (kt %s)", out["glass"],
        out["kt_start"].tolist())
    line = train_line(out, args.train_res, tcfg.samples_per_pixel)
    print(json.dumps(line), flush=True)
    assert line["loss_reduced"], "training must reduce the loss"
    return 0


if __name__ == "__main__":
    sys.exit(main())

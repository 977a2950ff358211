"""engine-compatible CLI (main.c:23-89, render.c:61-116), as in
``c_raytracer_tpu.cli.engine``, rendering on an NVIDIA GPU by default.

Same positional arguments and flags as the reference raytracer:

  engine <input.json> <output.tif> <resx> <resy> [flags]

  -m (int|"max")  thread count      — accepted and ignored
  -b (int)        max bounces               DEFAULT 10
  -a (float)      min light intensity       DEFAULT 0.01
  -s phong|blinn  reflection model          DEFAULT phong
  -n (int)        samples per pixel         DEFAULT 1
  -r norm|float   scene scale               DEFAULT 1.0
  -l none|lin|sqr light attenuation         DEFAULT sqr
  -o (float)      attenuation offset        DEFAULT 1
  -p real|cpu     log clock                 DEFAULT real
  -g ambient|path global illumination       DEFAULT ambient
  -f              save raw float32 + z-buffer for postprocessing
  --device (str)  torch device              DEFAULT cuda

Run as ``python -m c_raytracer_tpu_torch.cli.engine``.  There is no
fallback: without a card, and without ``--device cpu``, the run fails.
"""

from __future__ import annotations

import os
import sys
import time

HELPTEXT = """Render a scene using raytracing (PyTorch / CUDA engine).
Usage: engine <input> <output> <resolution x> <resolution y> [OPTIONAL_PARAMETERS]

REQUIRED PARAMETERS:
<input>      (string)            : .json scene file which will be used to generate the image.
<output>     (string)            : .tif file to which the image will be saved.
<resolution> (integer) (integer) : resolution of the output image.
OPTIONAL PARAMETERS:
[-m] (integer | "max")           : DEFAULT = 1       : accepted for compatibility (ignored).
[-b] (integer)                   : DEFAULT = 10      : maximum number of times that a light ray can bounce.
[-a] (float)                     : DEFAULT = 0.01    : minimum light intensity for which a ray is cast.
[-s] ("phong" | "blinn")         : DEFAULT = phong   : reflection model.
[-n] (integer)                   : DEFAULT = 1       : number of samples which are rendered per pixel.
[-r] ("norm" | float)            : DEFAULT = 1.0     : scene scaling factor.
[-l] ("none" | "lin" | "sqr")    : DEFAULT = sqr     : light attenuation.
[-p] ("real" | "cpu")            : DEFAULT = real    : time to print with status messages.
[-g] (string)                    : DEFAULT = ambient : global illumination model (ambient | path).
[-o] (float)                     : DEFAULT = 1       : light attenuation offset.
[-f]                             : DEFAULT = OFF     : save raw output for post-processing.
[--seed] (integer)               : DEFAULT = 0       : Philox stream seed (renders are deterministic; the stream differs from the JAX package's by design).
[--chunks] (integer)             : DEFAULT = 1       : progressive sample chunks (checkpointed with --checkpoint).
[--checkpoint] (string)          : DEFAULT = OFF     : raw-TIFF render checkpoint; resumes if present.
[--profile] (string)             : DEFAULT = OFF     : write a torch.profiler Chrome trace to this directory.
[--stats]                        : DEFAULT = OFF     : print traced-ray counts, rays/second, kernel launches and the host counters.
[--accel-report]                 : DEFAULT = OFF     : print the acceleration spill report (accel/validate.py).
[--accel-tune]                   : DEFAULT = OFF     : auto-raise visit budgets until the measured spill is zero.
[--shadow-mode] (string)         : DEFAULT = auto    : soft-shadow sweep (auto | shared | per_ray | union).
[--visits] (integer)             : DEFAULT = auto    : closest-hit cluster visit budget (bvh_visits).
[--shadow-visits] (integer)      : DEFAULT = auto    : shadow-sweep cluster visit budget (bvh_shadow_visits).
[--device] (string)              : DEFAULT = cuda    : torch device to render on (cuda | cuda:N | cpu); no fallback.
"""


def _flag(argv, name, nargs=1):
    if name in argv:
        i = argv.index(name)
        if nargs == 0:
            return True
        return argv[i + 1:i + 1 + nargs]
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(HELPTEXT)
        return 0
    if len(argv) < 4:
        print("Too few arguments. Use --help to find out which arguments "
              "are required to call this program.")
        return 1

    from c_raytracer_tpu_torch.core.logging import init as log_init, printf_log
    p = _flag(argv, "-p")
    log_init(p[0] if p else "real")

    import torch

    from c_raytracer_tpu_torch.core.rng import PhiloxSampler
    from c_raytracer_tpu_torch.image import write_tiff_raw, write_tiff_rgb8
    from c_raytracer_tpu_torch.render import RenderConfig
    from c_raytracer_tpu_torch.scene import load_scene

    inp, outp = argv[0], argv[1]
    resx, resy = abs(int(argv[2])), abs(int(argv[3]))

    kw = {}
    v = _flag(argv, "-b")
    if v:
        kw["max_bounces"] = abs(int(v[0]))
    v = _flag(argv, "-a")
    if v:
        kw["min_light_intensity"] = float(v[0])
    v = _flag(argv, "-s")
    if v and v[0] in ("phong", "blinn"):
        kw["reflection_model"] = v[0]
    v = _flag(argv, "-g")
    if v and v[0] in ("ambient", "path"):
        kw["gi_model"] = v[0]
    v = _flag(argv, "-n")
    if v:
        kw["samples_per_pixel"] = abs(int(v[0]))
    v = _flag(argv, "-l")
    if v and v[0] in ("none", "lin", "sqr"):
        kw["light_attenuation"] = v[0]
    v = _flag(argv, "-o")
    if v:
        kw["attenuation_offset"] = float(v[0])
    v = _flag(argv, "--shadow-mode")
    if v:
        if v[0] not in ("auto", "shared", "per_ray", "union"):
            print("Invalid --shadow-mode [%s]: expected one of "
                  "auto | shared | per_ray | union." % v[0])
            return 1
        kw["shadow_mode"] = v[0]
    v = _flag(argv, "--visits")
    if v:
        kw["bvh_visits"] = abs(int(v[0]))
    v = _flag(argv, "--shadow-visits")
    if v:
        kw["bvh_shadow_visits"] = abs(int(v[0]))
    cfg = RenderConfig(**kw)

    scale = None
    v = _flag(argv, "-r")
    if v:
        scale = "norm" if v[0] == "norm" else float(v[0])

    v = _flag(argv, "--device")
    device = torch.device(v[0] if v else "cuda")
    seed = _flag(argv, "--seed")
    sampler = PhiloxSampler(int(seed[0]) if seed else 0, device)

    printf_log("Loading scene.")
    scene = load_scene(inp, scale=scale)
    if scene.static.n_triangles > 1:
        # Morton-order triangles for the cluster traversal (the reference
        # builds its LBVH here too: accel_init after scene_load, main.c:76)
        from c_raytracer_tpu_torch.accel import reorder_scene
        printf_log("Generating the BVH.")
        scene = reorder_scene(scene)

    if _flag(argv, "--accel-report", nargs=0) or \
            _flag(argv, "--accel-tune", nargs=0):
        from c_raytracer_tpu_torch.accel.validate import (spill_report,
                                                          tuned_config)
        any_transp = any(scene.static.is_transparent)
        if _flag(argv, "--accel-tune", nargs=0):
            cfg, rep = tuned_config(scene, cfg, resx, resy, device=device)
            printf_log(
                "Accel auto-tune: visits=%d shadow_visits=%d shortlist=%d.",
                cfg.resolved_visits(any_transp),
                cfg.resolved_shadow_visits(any_transp),
                cfg.resolved_shadow_shortlist(any_transp))
        else:
            rep = spill_report(scene, cfg, resx, resy, device=device)
        printf_log("Accel spill report: %s.", rep)

    profile_dir = _flag(argv, "--profile")
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()

    printf_log("Commencing raytracing.")
    show_stats = _flag(argv, "--stats", nargs=0)
    if show_stats:
        # the program's counters (core/tracing.py), for the frame only
        from c_raytracer_tpu_torch.core import tracing
        tracing.reset()
        tracing.enable()
    chunks = _flag(argv, "--chunks")
    ckpt = _flag(argv, "--checkpoint")

    def warn_spill(stats):
        """Always-on runtime truncation guard: loud, not fatal — raise
        the budgets or use --accel-tune (accel/validate.py policy)."""
        sspill = float(stats.get("shadow_spill_max", 0.0))
        vspill = float(stats.get("visit_spill_max", 0.0))
        if sspill > 0:
            printf_log(
                "WARNING: shadow visit budget EXCEEDED by up to %.0f "
                "clusters per pixel — the kt tint product may have "
                "dropped blockers (light leak).  Raise bvh_shadow_visits "
                "or run with --accel-tune.", sspill)
        if vspill > 0:
            printf_log(
                "WARNING: closest-hit visit budget EXCEEDED by up to "
                "%.0f clusters per ray (nearest-first pruning usually "
                "masks this; spill 0 would prove exhaustiveness).  Raise "
                "bvh_visits or run with --accel-tune.", vspill)
        return sspill == 0 and vspill == 0

    t_render = time.perf_counter()
    if chunks or ckpt:
        from c_raytracer_tpu_torch.render import render_progressive
        img, z = render_progressive(
            scene, cfg, resx, resy, sampler, device=device,
            chunks=int(chunks[0]) if chunks else 1,
            checkpoint=ckpt[0] if ckpt else None,
            log=printf_log)
    else:
        # the truncation guard is ALWAYS on: a plain invocation of an
        # adversarial low-budget scene must warn, not silently ship a
        # truncated frame
        from c_raytracer_tpu_torch.render import make_renderer
        fn = make_renderer(scene.static, cfg, resx, resy, device=device,
                           with_stats=True)
        img, z, stats = fn(scene.params, sampler)
        img, z = img.cpu().numpy(), z.cpu().numpy()   # waits for the frame
        if show_stats:
            tracing.disable()
            dt = time.perf_counter() - t_render
            stats = {k: float(x) for k, x in stats.items()}
            total = stats["main_rays"] + stats["shadow_rays"] \
                + stats["gi_rays"]
            printf_log(
                "Traced %.3e rays (%.3e main, %.3e shadow, %.3e GI, "
                "%.0f dropped) in %.2fs: %.3e rays/s.",
                total, stats["main_rays"], stats["shadow_rays"],
                stats["gi_rays"], stats["dropped"], dt, total / dt)
            if warn_spill(stats):
                printf_log("Shadow sweep exhaustive (spill 0).")
            counts = tracing.totals()
            printf_log("Kernel launches: philox_uniform %d, "
                       "fused_shadow_chunk %d, visit_order %d.",
                       counts.get("kernel.philox_uniform", 0),
                       counts.get("kernel.fused_shadow", 0),
                       counts.get("kernel.visit_order", 0))
            printf_log("Host counters: %s.", ", ".join(
                f"{k} {v}" for k, v in sorted(counts.items())
                if not k.startswith("kernel.")))
        else:
            warn_spill(stats)

    if prof is not None:
        prof.stop()
        os.makedirs(profile_dir[0], exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir[0], "trace.json"))
        printf_log("Profiler trace written to [%s].", profile_dir[0])

    printf_log("Saving image.")
    if not outp.endswith((".tif", ".tiff")) and ".tif" not in outp:
        printf_log("Expected output file [%s] with extension .tif.", outp)
    if _flag(argv, "-f", nargs=0):
        write_tiff_raw(outp, img, z)
    else:
        write_tiff_rgb8(outp, img)
    printf_log("Terminating.")
    return 0


if __name__ == "__main__":
    sys.exit(main())

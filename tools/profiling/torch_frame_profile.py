"""Where one frame (or one gradient step) of the PyTorch port's main path
spends its time on a GPU.

    python3 tools/profiling/torch_frame_profile.py [--scene scenes/X.json]
        [--res 1024] [--seed 0] [--tree DIR] [--gi-spp N] [--lights N]
        [--light-chunk N] [--fwd-bwd] [--remat-names A,B] [--no-profile]

Renders a scene (default scenes/spheres_opaque.json; mesh scenes are put in
Morton order first) under RenderConfig() (with ``--gi-spp N``, path GI at N
samples a pixel; ``--lights N`` caps every emitter's light samples at N,
``--light-chunk`` sets the chunk: bench.py's flagship is ``--scene
scenes/meshes_glass.json --res 64 --gi-spp 4 --lights 24 --light-chunk
8``) once to warm up, then once under torch.profiler.  With
``--fwd-bwd`` each of the two is a forward+backward step of mean(img²)
over every SceneParams leaf, and kernel 2's backward calls are annotated
(``fused_chunk_backward``): on the dense stand-in at 1024² the profiled
step takes about four minutes, most of it the profiler's own processing.
``--remat-names`` sets ``RenderConfig.remat_names`` (comma-separated).
It prints the warm-up's wall seconds and peak device memory (no
profiler), and then, unless ``--no-profile``: the frame's wall seconds, the
device busy seconds (the sum of CUDA kernel times; one stream, so kernels
do not overlap), the idle share, the kernel launch count, the host time in
stream syncs, the kernels with the most device time and the host ops with
the most self CPU time, and the device time of each of the port's own
kernels.  ``--tree`` profiles the port of another checkout's root (to
compare two commits on one card).  Needs a CUDA device; imports the port
only (never JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT_KERNELS = ("philox_uniform_kernel", "fused_shadow_kernel",
                "visit_order_kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=os.path.join(ROOT, "scenes",
                                                    "spheres_opaque.json"))
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--gi-spp", type=int, default=0,
                    help="path GI at this many samples a pixel (0: ambient)")
    ap.add_argument("--lights", type=int, default=0,
                    help="cap every emitter's light samples (0: as loaded)")
    ap.add_argument("--light-chunk", type=int, default=40)
    ap.add_argument("--fwd-bwd", action="store_true",
                    help="profile a forward+backward step, not a frame")
    ap.add_argument("--remat-names", default="occlusion",
                    help="RenderConfig.remat_names, comma-separated")
    ap.add_argument("--no-profile", action="store_true",
                    help="time the warm-up only")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from c_raytracer_tpu_torch.accel import reorder_scene
    from c_raytracer_tpu_torch.core import rng
    from c_raytracer_tpu_torch.render import RenderConfig
    from c_raytracer_tpu_torch.render.api import make_renderer
    from c_raytracer_tpu_torch.render import fused_shadow
    from c_raytracer_tpu_torch.scene import (load_scene, named_leaves,
                                             params_to_torch)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)   # a context before the peak reset
    sc = reorder_scene(load_scene(args.scene))
    static = sc.static
    if args.lights:
        static = dataclasses.replace(static, num_lights=tuple(
            min(n, args.lights) for n in static.num_lights))
    cfg = RenderConfig(light_chunk=args.light_chunk,
                       remat_names=tuple(args.remat_names.split(",")))
    if args.gi_spp:
        cfg = dataclasses.replace(cfg, gi_model="path",
                                  samples_per_pixel=args.gi_spp)
    render = make_renderer(static, cfg, args.res, args.res, device=dev,
                           with_stats=True)
    sampler = rng.PhiloxSampler(args.seed, dev)
    params = sc.params
    if args.fwd_bwd:
        params = params_to_torch(sc.params, dev)
        for _, x in named_leaves(params):
            x.requires_grad_(True)

    def run():
        if args.fwd_bwd:
            for _, x in named_leaves(params):
                x.grad = None
        img, _, st = render(params, sampler)
        if args.fwd_bwd:
            img.square().mean().backward()
        return st

    real_bwd = fused_shadow._FusedChunk.backward

    def annotated(ctx, g):
        with torch.profiler.record_function("fused_chunk_backward"):
            return real_bwd(ctx, g)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    print(f"warm-up {'fwd+bwd step' if args.fwd_bwd else 'frame'} "
          f"{args.res}x{args.res}, remat_names {cfg.remat_names}: wall "
          f"{time.perf_counter() - t0:.6f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    if args.no_profile:
        return
    fused_shadow._FusedChunk.backward = staticmethod(annotated)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stats = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        fused_shadow._FusedChunk.backward = staticmethod(real_bwd)

    events = prof.key_averages()
    # the annotation's own range on the device is a span, not a kernel
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key != "fused_chunk_backward"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    sync = sum(e.cpu_time_total for e in events
               if e.key in ("cudaStreamSynchronize",
                            "cudaDeviceSynchronize")) / 1e6
    what = "fwd+bwd step" if args.fwd_bwd else "frame"
    print(f"{what} {args.res}x{args.res}: wall {wall:.6f} s (under the "
          f"profiler), device busy {busy:.6f} s, idle share "
          f"{1 - busy / wall:.4f}, {launches} kernel launches, host in "
          f"stream syncs {sync:.6f} s")
    rays = sum(float(stats[k]) for k in ("main_rays", "shadow_rays",
                                         "gi_rays"))
    print(f"rays {rays:.0f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        print(f"{e.self_device_time_total / 1e3:9.3f} ms  n={e.count:6d}  "
              f"{e.key[:100]}")
    for name in PORT_KERNELS:
        mine = [e for e in kernels if name in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        n = sum(e.count for e in mine)
        print(f"port kernel {name}: {ms:.3f} ms over {n} launches")
    k2b = [e for e in events if e.key == "fused_chunk_backward"
           and e.device_type == DeviceType.CPU]
    if k2b:
        print(f"kernel 2's backward (its plain version's autograd): "
              f"{k2b[0].device_time_total / 1e3:.3f} ms over {k2b[0].count} "
              f"calls")
    print("host ops by self CPU time:")
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"{e.self_cpu_time_total / 1e3:9.3f} ms  n={e.count:6d}  "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()

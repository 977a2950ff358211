"""Where one frame of the PyTorch port's main path spends its time on a GPU.

    python3 tools/profiling/torch_frame_profile.py [--scene scenes/X.json]
        [--res 1024] [--seed 0] [--tree DIR]

Renders a scene (default scenes/spheres_opaque.json; mesh scenes are put in
Morton order first) under RenderConfig() once to warm up, then once under
torch.profiler, and prints: the frame's wall seconds, the
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
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from c_raytracer_tpu_torch.accel import reorder_scene
    from c_raytracer_tpu_torch.core import rng
    from c_raytracer_tpu_torch.render import RenderConfig
    from c_raytracer_tpu_torch.render.api import make_renderer
    from c_raytracer_tpu_torch.scene import load_scene
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    sc = reorder_scene(load_scene(args.scene))
    render = make_renderer(sc.static, RenderConfig(), args.res, args.res,
                           device=dev, with_stats=True)
    sampler = rng.PhiloxSampler(args.seed, dev)
    render(sc.params, sampler)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = render(sc.params, sampler)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    sync = sum(e.cpu_time_total for e in events
               if e.key in ("cudaStreamSynchronize",
                            "cudaDeviceSynchronize")) / 1e6
    print(f"frame {args.res}x{args.res}: wall {wall:.6f} s (under the "
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
    print("host ops by self CPU time:")
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"{e.self_cpu_time_total / 1e3:9.3f} ms  n={e.count:6d}  "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()

"""Compiler report and A/B device and frame times for the port's CUDA
kernels on a GPU.

    python3 tools/profiling/kernel_check.py [--ptxas] [--frames N]
        [--tree DIR] [--seed 0]

* ``--ptxas`` compiles every ``c_raytracer_tpu_torch/csrc/*.cu`` with the
  port's nvcc flags plus ``-Xptxas -v`` (into the gitignored ``_build/``)
  and prints each kernel's registers, stack frame and spills.
* Always: one JSON line of the device times (torch.profiler, as
  chip_smoke.py phase 10) of kernel 3 (the cluster visit order) on the
  first round of the mesh stand-in's middle 2048-ray tile (K = 8,556,
  V = 16) and on random rays at V = 64 with ``count_max_dist``, and of
  kernel 2 (the fused soft-shadow chunk) on the first chunk of the dense
  stand-in's first and second rounds, for the port in ``--tree`` (a
  checkout's root, default this one).
* ``--frames N`` adds to that line the frame seconds of both main paths
  (the dense stand-in at 1024x1024, the mesh stand-in at 512x512, under
  RenderConfig(); one warm-up frame, then N timed frames, as chip_smoke.py
  phases 6 and 9), with each path's rays per pixel and peak device memory.

Run it on two checkouts in turns (parent, change, change, parent) to
compare two designs on one card.  Needs a CUDA device; imports the port
and chip_smoke.py's helpers only (never JAX).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_port(tree: str):
    """Put the port of ``tree`` first on the path, then load this
    checkout's chip_smoke.py (its helpers take the port's public calls
    only, which both designs share)."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def ptxas_report(native) -> None:
    """Each kernel's ptxas resource lines, by source."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    procs = {}
    for src in native.sources():
        out = os.path.join(native.BUILD_DIR, f"ptxas_{src}.so")
        procs[src] = subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             out, os.path.join(native._CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for src, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src}:\n{text}")
        name = "?"
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = subprocess.run(["c++filt", m.group(1)],
                                      capture_output=True, text=True,
                                      check=False).stdout.strip() or m.group(1)
            elif "bytes stack frame" in line or "Used " in line:
                print(f"ptxas {src} {name}: {line.split(':', 1)[-1].strip()}")


def frame_times(cs, dev, n: int, seed: int) -> dict:
    """Frame seconds, rays per pixel and peak MiB of both main paths."""
    out = {}
    for name, path, res, reorder in (("dense", cs.SCENE, 1024, False),
                                     ("mesh", cs.MESH_SCENE, cs.MESH_RES,
                                      True)):
        sc = cs.load_scene(os.path.join(ROOT, path))
        if reorder:
            sc = cs.reorder_scene(sc)
        render = cs.make_renderer(sc.static, cs.RenderConfig(), res, res,
                                  device=dev, with_stats=True)
        _, _, st, secs, _, peak = cs.time_frames(
            render, sc.params, cs.rng.PhiloxSampler(seed, dev), dev, {}, n)
        rays = st["main_rays"] + st["shadow_rays"] + st["gi_rays"]
        out[name] = {"frame_s": secs, "rays_per_px": rays / res ** 2,
                     "peak_mib": peak / 2 ** 20}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    cs = load_port(args.tree)
    from c_raytracer_tpu_torch import _native
    from c_raytracer_tpu_torch.render.camera import primary_rays
    from c_raytracer_tpu_torch.scene import params_to_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if args.ptxas:
        ptxas_report(_native)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"tree": args.tree, "device": torch.cuda.get_device_name(0)}
    if args.frames:    # first, so that the peak holds the frames alone
        out["frames"] = frame_times(cs, dev, args.frames, args.seed)
    pv, fs = cs.pallas_visit, cs.fused_shadow

    # kernel 3: the middle tile's first round, and random rays at V = 64
    cfg = cs.RenderConfig()
    msc = cs.reorder_scene(cs.load_scene(os.path.join(ROOT, cs.MESH_SCENE)))
    mparams = params_to_torch(msc.params, dev)
    ix = cs.make_intersector(cs.device_scene(mparams, msc.static),
                             msc.static, cfg)
    lo, hi = ix.clusters.lo, ix.clusters.hi
    K = lo.shape[0]
    o_all, d_all = primary_rays(mparams.camera, cs.MESH_RES, cs.MESH_RES)
    mid = (cs.MESH_RES ** 2 // cs.MESH_TILE) // 2
    o = o_all[mid * cs.MESH_TILE:(mid + 1) * cs.MESH_TILE].contiguous()
    d = d_all[mid * cs.MESH_TILE:(mid + 1) * cs.MESH_TILE].contiguous()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ro = torch.rand((4096, 3), generator=gen, device=dev) * 8 - 4
    rd = torch.randn((4096, 3), generator=gen, device=dev)
    rd = rd / rd.norm(dim=1, keepdim=True)
    cmd = torch.rand((4096,), generator=gen, device=dev) * 4

    # kernel 2: the first chunk of the dense stand-in's first two rounds
    sc = cs.load_scene(os.path.join(ROOT, cs.SCENE))
    chunks = cs.capture_round_chunks(sc.static, sc.params, dev)[:2]

    times = {
        "visit_order V=16 mid tile": cs.device_ms(
            lambda: pv.visit_order(o, d, lo, hi, 16)),
        "visit_order V=64 R=4096 count_max_dist": cs.device_ms(
            lambda: pv.visit_order(ro, rd, lo, hi, 64, cmd)),
    }
    for rnd, (u, px, scal_f, n_valid, kw) in enumerate(chunks, 1):
        times[f"fused_shadow_chunk round {rnd}"] = cs.device_ms(
            lambda: fs.fused_chunk(u, px, scal_f, n_valid, **kw))
    out["device_ms"] = times
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels of c_raytracer_tpu_torch/csrc/ (nvcc, sm_90a,
one library per source, all compiled at once, into
c_raytracer_tpu_torch/_build/), holds each kernel against its plain PyTorch
version on the card, renders small frames on the card against the same
frames on the CPU, and drives the port's two main paths under the default
RenderConfig, timing each: the dense stand-in (scenes/spheres_opaque.json)
at 1024x1024 (phases 3-6: Philox, fused shadow), and the mesh stand-in
(scenes/meshes_opaque.json, 136,896 triangles in Morton clusters) at
512x512 (phases 7-9: the cluster visit order).  Phase 10 times every
kernel on the device at the main paths' shapes and sets each beside its
bound, kernel 2's backward included.  Phases 11-13 take gradients: card
against CPU grads of every SceneParams leaf on small dense and mesh frames
(11), then a forward+backward step of each main path, the dense stand-in
at 1024x1024 (12, with the peak memory of the step without
rematerialisation) and the mesh stand-in at 256x256 (13).  Phases 14-18
drive the stack integrator of transparent scenes: kernel 3 at the glass
stand-in's shapes with lists of 64, 128 and 256 (14); small glass and
scenes/example.json frames, card against CPU (15); the glass stand-in
(scenes/meshes_glass.json, the dragon in glass, union shadows) at 64x64
under RenderConfig() (16);
scenes/example.json at 1024x1024 (17); a forward+backward step of the
glass stand-in at 64x64 and card against CPU grads of a 16x16 glass frame
(18).  Phases 19-23 drive path-traced GI (``gi_model="path"``) and the
host-tiled entry points: dense 64x64 and glass 32x32 GI frames, card
against CPU, and kernels 1-3 against their plain versions at the GI
shapes (the hemisphere draws, a light chunk at GI child hits, the visit
order of a GI child trace at lists of 64, 128 and 256) (19-20); the dense
stand-in at 1024x1024 under bench.py's path-GI settings (spp 4), a frame
and a forward+backward step (21); the host-tiled renderer against
make_renderer, bit for bit (22); and the flagship, bench.py's scene5
value-and-grad on the glass stand-in (64x64, 24 lights, spp 4,
light_chunk 8), one host-tiled frame and one host-tiled value-and-grad
step, with card against CPU grads at 8x8 (23).  Phases 24-28 drive the
reference's two programs: kernel 3 at lists of 384, 512 and 1024 (passes
of 256) on the mesh and glass stand-ins' boxes, bit-equal to plain (24);
the engine CLI as a subprocess on the default device, the dense stand-in
at 1024x1024 raw and 8-bit, its files against the in-process frame (25);
a progressive 1024x1024 render stopped after 2 of 4 checkpointed chunks
and resumed, against the uninterrupted one, and render_spp_chunked of
dense path GI against the single call (26); --accel-report on the mesh
stand-in at 512x512 and --accel-tune on the glass stand-in at 64x64
through the engine's main, and the card's spill reports against the
CPU's at 64x64 (27); the postprocess CLI on phase 25's raw file, card
against CPU, and the reference's postprocess goldens on the card (28).  Phases
29-31 drive the JAX package's opt-ins: the two-level super-cluster visit
order (``bvh_super_group``), kernel 3 at the super level's shape bit-equal
to plain, small frames card vs CPU and against the dense order, and
256x256 mesh frames at the defaults and at S = 16 and 48 in turns (29);
closest-hit ray compaction at 256x256 in tiles of 16384, on vs off
bit-equal, and frame seconds on, off and at the default tile (30); and one glass
forward+backward step at 32x32 (3 bounces) under the default
``remat_names`` and all three names, with its seconds, peak and grads
against the default names' (31).
Phases 32-34 drive the mesh of ranks (parallel/): kernel 3 at the
per-shard shape (the mesh stand-in's 4 triangle ranges) bit-equal to
plain and timed, exhaustive 64x64 mesh frames in 2 and 4 stacked
ranges and 32x32 glass frames in 2 bit-equal to unsharded, and 256x256
mesh frames by range count (32); two gloo ranks sharing the card
(px = 2 dense 1024x1024, pr = 2 mesh 64x64, sp = 2 dense GI 64x64
against one process; a dense and a mesh train step, grads within
1e-6·max|g| of one process; the collectives' host ms), and the dense step
on an NCCL group of one rank (33); the multichip dry run on two gloo
ranks sharing the card (34).
Phases 35-37 drive the tools (c_raytracer_tpu_torch/tools/): the roofline
probes' kernels (csrc/roofline.cu) against their plain versions at the
probes' full sizes, then each probe timed against its published peak
(35); the flagship tool as a subprocess on the card (8x8 at spp 2 in 2
chunks, 4 lights, 2 of its 6 train steps at 8x8), both of its JSON lines
checked, and its forward phase card against CPU at 8x8 (36); the
scaling tool at 1 and 2 gloo ranks sharing the card, each count's frame
bit-equal to one process's (37).  Phase 38 drives the four scene5
diagnostics (tools/s5_*.py) on the full glass stand-in, all four at once
as subprocesses on the card (s5_diag 16, s5_union_stats 32 8,
s5_trunc_sweep 16 2, s5_union_bench 16 8), each line of its JAX script
there and finite, with their kernels' launches; s5_diag and
s5_union_stats also in this process, every count card against CPU.  Its
runs, phase 37 and phase 36's own card against CPU forward go beside
phase 36's flagship tool.
To fit the time limit the flagship runs at 2 bounces (its grads at 1
and 8x8), the mesh path times 2 frames and its step runs at 256x256, the
glass path times 1 frame and its 16x16 grads run at 2 bounces, phase 31
takes two remat_names tuples of four, phases 29, 30 and 32 time
their mesh frames at 256x256, the glass frames that count kernel 3's
launches at bvh_visits = 128, 256 and 512 run at 32x32, and phases 37-38
run beside phase 36's tool.
Each phase prints one
line or a few; any failed check raises, so the script exits non-zero and
prints no result.  The last two lines are the kernels' JSON summary and
the run's result line.  The profile of the dense forward+backward step is
``tools/profiling/torch_frame_profile.py --fwd-bwd``.

Kernel times: ``device ms`` is the CUDA kernel time that torch.profiler
records over 50 launches, divided by the launches it recorded (phase 10
runs it twice for each shape); ``issue ms`` is the older CUDA-
event time around 20 launches issued one by one from Python, which for a
short kernel measures the host's issue rate.  ``bound ms`` is the least
time an H100 SXM could take for the same work: the larger of the bytes
moved (each input read once, each output written once) over 3.35 TB/s and
the float operations over 67 TFLOP/s.  Kernel 2's operations weigh each
sinf/cosf, powf and division by what the roofline tool's chains measure
on the card in phase 10 (``ops_count: "probe-weighted"``), a sqrtf at 4;
the data-sheet count (205 a live sample) stays beside it.

It imports torch, numpy and the port only (never JAX).
"""

from __future__ import annotations

import argparse
import ast
import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from c_raytracer_tpu_torch import _native
from c_raytracer_tpu_torch.accel import make_intersector, reorder_scene
from c_raytracer_tpu_torch.accel import pallas_visit
from c_raytracer_tpu_torch.core import rng
from c_raytracer_tpu_torch.geometry import device_scene
from c_raytracer_tpu_torch.render import (RenderConfig, fused_shadow,
                                          integrator, shading)
from c_raytracer_tpu_torch.render import api
from c_raytracer_tpu_torch.render.api import (make_host_tiled_renderer,
                                              make_host_tiled_value_and_grad,
                                              make_renderer)
from c_raytracer_tpu_torch.render.integrator import GI_TAG
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.scene import load_scene, params_to_torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = "scenes/spheres_opaque.json"
MESH_SCENE = "scenes/meshes_opaque.json"
MESH_RES = 512
MESH_STEP_RES = 256   # the mesh forward+backward step's frame (phase 13)
MESH_TILE = 2048      # the auto tile of a cluster scene
GLASS_SCENE = "scenes/meshes_glass.json"
GLASS_RES = 64
MESH_FRAMES = 2       # timed frames of the mesh and glass main paths: few
GLASS_FRAMES = 1      # enough to keep the run within its time
EXAMPLE_SCENE = "scenes/example.json"
GLASS_LISTS = (64, 128, 256)   # kernel 3's list sizes on the glass path
# the glass frames that count kernel 3's launches at bvh_visits = 128, 256
# (phase 14) and 512 (phase 24): one tile, to keep the run within its time
GLASS_LAUNCH_RES = 32
# path GI at bench.py:97's settings, and bench.py:251-285's flagship (its
# lights capped at 24; the auto cluster tile of 2048, not its tile of 512;
# cut to 2 bounces, FLAGSHIP_BOUNCES, to keep the run within its time)
GI_CFG = RenderConfig(gi_model="path", samples_per_pixel=4)
FLAGSHIP_BOUNCES = 2
FLAGSHIP_CFG = RenderConfig(gi_model="path", samples_per_pixel=4,
                            light_chunk=8, max_bounces=FLAGSHIP_BOUNCES)
FLAGSHIP_LIGHTS = 24
FLAGSHIP_GRAD_RES = 8   # its card vs CPU grads (the CPU's time)
KAT = {  # Random123 philox4x32_10, counter 0, key 0
    "ctr0_key0": (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)}
COMBOS = [(phong, att) for phong in (True, False)
          for att in ("none", "lin", "sqr")]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# float operations per unit of work, counted from the kernels' formulas:
# the slab test of one box (6 sub, 6 mul, 12 min/max, the clamp and the
# overlap compare); one live soft-shadow sample of csrc/fused_shadow.cu by
# kind (plain operations, sinf/cosf, sqrtf, IEEE divisions, powf), and
# each occluding sphere and plane it is tested against
VISIT_OPS_PER_BOX = 25
FUSED_PER_SAMPLE = {"plain": 79, "sin": 4, "sqrt": 2, "div": 2, "pow": 1}
# what one sqrtf, sinf or cosf, IEEE division and powf weigh in float32
# operations: the data-sheet count the bound used first (205 a sample),
# and the sqrtf's weight, which the probe-weighted count keeps; phase 10
# weighs the rest by the roofline probes' chains (tools/roofline.py)
DATASHEET_OP_WEIGHTS = {"sqrt": 4, "sin": 20, "div": 4, "pow": 30}
FUSED_OPS_PER_SPHERE = 30
FUSED_OPS_PER_PLANE = 25
# card against CPU grads, each leaf: max |diff| <= GRAD_MAX_RTOL · scale
# and, for leaves of 1000 entries or more, >= 99.9% of the entries within
# GRAD_RTOL · scale; scale = the larger max |grad| of the two over the leaf
# (camera.focal_length, whose exact gradient is 0, at camera.position's)
GRAD_RTOL = 1e-3
GRAD_MAX_RTOL = 1e-2
GRAD_SCALE_OF = {"camera.focal_length": "camera.position"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_START = time.perf_counter()


def phase(n: int, msg: str) -> None:
    """One result line, with the seconds since the script started."""
    print(f"[phase {n}] [{time.perf_counter() - _START:.0f} s] {msg}",
          flush=True)


def issue_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of fn() over reps calls issued one by one, by
    CUDA events: the host's issue rate for a short kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, n: int = 50, tries: int = 3) -> float:
    """Device milliseconds per call of fn() over n calls under
    torch.profiler: for a call that launches one kernel, that kernel's
    recorded time over its recorded count (the profiler may drop the first
    few records of a run); for a plain version of many kernels, their
    recorded time over n.  A profile that came back with too few records
    (now and then it holds none; of a kernel of 0.2 ms or more it may keep
    only the last dozen launches) is taken again, up to ``tries`` profiles
    in all: a one-kernel call needs 1/5 of its launches, whose mean it
    takes, a plain version of many kernels 4/5, as it divides by n."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kernels)
        count = sum(e.count for e in kernels)
        what = (f"torch.profiler recorded {us} us over "
                f"{[(e.key[:60], e.count) for e in kernels]}")
        enough = n // 5 if len(kernels) == 1 else n * 4 // 5
        if us > 0 and count >= enough:
            return us / (count if len(kernels) == 1 else n) / 1e3
        print(f"[phase 10] profile {attempt} of {tries}: {what}", flush=True)
    check(False, what)


def pass_ms(fn, V: int, n: int = 50, tries: int = 3) -> float:
    """Device milliseconds per call of kernel 3 at V slots, ``fn()`` one
    such call: under torch.profiler, the mean time a launch of each
    compiled list size, summed over the call's passes
    (``pallas_visit.visit_passes``).  Means, not sums, so that records the
    profiler drops do not count as time saved."""
    vms = [pallas_visit.visit_split(1, V, v).vm
           for _, v in pallas_visit.visit_passes(V)]
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        means = {e.key: e.self_device_time_total / e.count / 1e3
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count >= n // 5}
        keys = [[k for k in means
                 if "visit_order_kernel" in k and f"<{vm}>" in k]
                for vm in vms]
        if all(len(k) == 1 for k in keys):
            return sum(means[k[0]] for k in keys)
        print(f"[phase 24] profile {attempt} of {tries}: {means}",
              flush=True)
    check(False, f"kernel 3 passes {vms}: no profile")


def paired(first, second, timer) -> tuple[list[float], list[float]]:
    """Runs of ``timer`` in the order first, second, second, first:
    ([first's two], [second's two])."""
    a1, b1, b2, a2 = (timer(f) for f in (first, second, second, first))
    return [a1, a2], [b1, b2]


def mean(xs) -> float:
    return sum(xs) / len(xs)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time for the work and what sets it: bytes over the
    memory rate or float operations over the float32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def probe_op_weights(dev) -> dict:
    """Float32 operations of peak that one sinf, powf and IEEE division
    cost on this card, from the roofline tool's chain probes (CUDA events,
    milliseconds each); the sqrtf keeps its data-sheet weight."""
    from c_raytracer_tpu_torch.tools import roofline as rf
    lines = {"sin": rf.probe_trans(dev), "pow": rf.probe_pow(dev),
             "div": rf.probe_div(dev)}
    return {"sqrt": DATASHEET_OP_WEIGHTS["sqrt"],
            **{k: line[f"f32_ops_per_{k}"] for k, line in lines.items()}}


def fused_bound(samples: int, P: int, live: int, n_scal: int, ns: int,
                npl: int, weights: dict) -> dict:
    """Kernel 2's bound on a chunk: the one of the probe-weighted
    operation count, as (ms, by), and beside it the data-sheet count's
    ms.  Bytes: u of the live samples, the okf row, the live pixels' other
    16 rows, the scene scalars, the (3, P) output."""
    need = 4 * (2 * samples + P + 16 * live + n_scal + 3 * P)
    occluders = FUSED_OPS_PER_SPHERE * (ns - 1) + FUSED_OPS_PER_PLANE * npl

    def ops(w):
        per = FUSED_PER_SAMPLE["plain"] + sum(
            n * w[k] for k, n in FUSED_PER_SAMPLE.items() if k != "plain")
        return samples * (per + occluders)

    return {"bound": bound_ms(need, ops(weights)),
            "datasheet_bound_ms": bound_ms(need,
                                           ops(DATASHEET_OP_WEIGHTS))[0]}


def time_line(what: str, dev: list[float], bound: tuple[float, str],
              **others) -> dict:
    """Print one timing line; return its numbers."""
    rec = {"device_ms": mean(dev), "device_runs": dev, "bound_ms": bound[0],
           "bound_by": bound[1], "share_of_bound": bound[0] / mean(dev),
           **others}
    extra = "; ".join(f"{k} {v:.6f}" if isinstance(v, float) else
                      f"{k} {v}" for k, v in others.items())
    print(f"[phase 10] {what}: device ms {[round(x, 6) for x in dev]} mean "
          f"{mean(dev):.6f}; bound {bound[0]:.6f} ms ({bound[1]}), share "
          f"{bound[0] / mean(dev):.3f}; {extra}", flush=True)
    return rec


def max_sample_contribution(u, px, scal_f, n_valid, kw) -> torch.Tensor:
    """Largest single-sample contribution per channel over all pixels: the
    bound for a pixel whose one sample flips an ulp-close occlusion test."""
    lc = kw["lc"]
    best = torch.zeros(3, device=u.device)
    for s in range(lc):
        one = fused_shadow.fused_chunk_reference(
            u[:, s:s + 1].contiguous(), px, scal_f, int(s < n_valid),
            **dict(kw, lc=1))
        best = torch.maximum(best, one.amax(dim=1))
    return best.max()


def compare_fused(u, px, scal_f, n_valid, kw) -> float:
    """Kernel 2 against its plain version on the card: >= 99.99% of the
    pixel-channels within rtol 1e-4 / atol 1e-6·max, and no pixel off by
    more than one sample's largest contribution.  Returns max |diff|."""
    got = fused_shadow.fused_chunk(u, px, scal_f, n_valid, **kw)
    want = fused_shadow.fused_chunk_reference(u, px, scal_f, n_valid, **kw)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = 1e-4 * want.abs() + 1e-6 * want.abs().max()
    frac = (diff <= tol).float().mean().item()
    bound = max_sample_contribution(u, px, scal_f, n_valid, kw).item()
    err = diff.max().item()
    check(bool(torch.isfinite(got).all()), f"fused {kw}: finite")
    check(frac >= 0.9999, f"fused {kw}: {frac:.6f} of channels within tol")
    check(err <= bound, f"fused {kw}: max diff {err} > one sample {bound}")
    return err


def record(module, name: str, run, keep) -> list:
    """Run ``run()`` with ``module.name`` wrapped: each call's arguments
    go through ``keep(*args, **kwargs)``, and what it returns, unless None,
    is kept.  Returns the kept records in call order."""
    calls = []
    real = getattr(module, name)

    def recording(*args, **kwargs):
        rec = keep(*args, **kwargs)
        if rec is not None:
            calls.append(rec)
        return real(*args, **kwargs)

    # the wrapper counts its launches on the module's name, now this one
    recording.launches = 0
    setattr(module, name, recording)
    try:
        run()
    finally:
        setattr(module, name, real)
    return calls


def capture_round_chunks(static, params, device):
    """The operands of the first fused chunk of every round of the stand-in
    scene at 256x256 under RenderConfig() (one tile of 65536 pixels: the
    main path's chunk shape), in round order."""
    def keep(u, px, scal_f, n_valid, **kw):
        if n_valid < max(static.num_lights):
            return None          # a round's later chunks
        return u.clone(), px.clone(), scal_f.clone(), n_valid, kw

    return record(fused_shadow, "fused_chunk", lambda: make_renderer(
        static, RenderConfig(), 256, 256, device=device)(
            params, rng.PhiloxSampler(11, device)), keep)


def compare_visit(o, d, lo, hi, V, count_max_dist=None):
    """Kernel 3 against its plain version on the card: bit-equal ok mask,
    spill, and cids and entry on ok slots.  Returns (ok slots, max spill,
    max |entry difference| on ok slots)."""
    kc, ke, ks = pallas_visit.visit_order(o, d, lo, hi, V, count_max_dist)
    pc, pe, ps = pallas_visit.visit_order_reference(o, d, lo, hi, V,
                                                    count_max_dist)
    torch.cuda.synchronize()
    what = f"visit_order R={o.shape[0]} K={lo.shape[0]} V={V}" + (
        " count_max_dist" if count_max_dist is not None else "")
    ok = pe < pallas_visit.FLT_MAX
    check(torch.equal(ke < pallas_visit.FLT_MAX, ok), f"{what}: ok mask")
    check(torch.equal(ks, ps), f"{what}: spill")
    check(torch.equal(kc[ok], pc[ok]), f"{what}: cids")
    err = (ke[ok] - pe[ok]).abs().max().item() if ok.any() else 0.0
    check(torch.equal(ke[ok], pe[ok]), f"{what}: entry")
    return int(ok.sum()), int(ps.max()), err


def record_mesh_calls(static, params, cfg, resx, resy, device, seed):
    """The visit-order operands of every call in one frame, in call order
    (the chain integrator calls it once per live round of each tile), and
    the shapes of the frame's uniform draws."""
    frame = make_renderer(static, cfg, resx, resy, device=device)
    shapes = []

    def run():
        shapes.extend(record(
            rng, "philox_uniform",
            lambda: frame(params, rng.PhiloxSampler(seed, device)),
            lambda key, shape, device: tuple(shape)))

    calls = record(pallas_visit, "visit_order", run,
                   lambda o, d, lo, hi, V, count_max_dist=None:
                   (o.clone(), d.clone(), lo, hi, V))
    return calls, shapes


def aimed_rays(lo, hi, R: int, gen):
    """R rays from random origins in [-4, 4)^3, ray i aimed at the centre
    of box i % K, so that every box is entered."""
    c = 0.5 * (lo + hi)[torch.arange(R, device=lo.device) % lo.shape[0]]
    o = torch.rand((R, 3), generator=gen, device=lo.device) * 8 - 4
    d = c - o
    return o, d / d.norm(dim=1, keepdim=True)


def frames_agree(a, b, what: str, share: float = 0.999) -> tuple[float,
                                                                  float]:
    """Card frame ``a`` against CPU frame ``b`` (image, z, stats): equal ray
    counts and spill maxima, >= ``share`` of pixels within 1e-4·max in
    image and z.  Returns the two fractions."""
    (gi, gz, gs), (ci, cz, cs) = a, b
    for k in ("main_rays", "shadow_rays", "shadow_spill_max",
              "visit_spill_max"):
        check(gs[k] == cs[k], f"{what} {k}: card {gs[k]} cpu {cs[k]}")
    pix = ((gi - ci).abs().amax(-1) <= 1e-4 * ci.max()).float().mean().item()
    zok = ((gz - cz).abs() <= 1e-4 * cz.max()).float().mean().item()
    check(pix >= share, f"{what} image: {pix:.5f} of pixels within 1e-4·max")
    check(zok >= share, f"{what} z: {zok:.5f} of pixels within 1e-4·max")
    return pix, zok


def render_on(device, static, params, cfg, res, seed):
    fn = make_renderer(static, cfg, res, res, device=device, with_stats=True)
    img, z, st = fn(params, rng.PhiloxSampler(seed, device))
    return img.cpu(), z.cpu(), {k: float(v) for k, v in st.items()}


def time_frames(render, params, sampler, dev, launch_fns, n=3):
    """Warm up, reset the launch counters, render ``n`` timed frames.
    Returns (image, z, stats, seconds, launches, peak bytes)."""
    render(params, sampler)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in launch_fns.values():
        fn.launches = 0
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, z, st = render(params, sampler)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in launch_fns.items()}
    st = {k: float(v) for k, v in st.items()}
    return img, z, st, secs, launches, torch.cuda.max_memory_allocated(dev)


def grad_params(params, device):
    """``params_to_torch`` with every leaf requiring grad: (params,
    [(name, leaf)])."""
    # imported here: tools/profiling/kernel_check.py loads this file's
    # helpers against checkouts of the port from before the gradients
    from c_raytracer_tpu_torch.scene import named_leaves

    p = params_to_torch(params, device)
    named = named_leaves(p)
    for _, x in named:
        x.requires_grad_(True)
    return p, named


def frame_grads(static, params, cfg, resx, resy, device, seed, w, wz):
    """{leaf name: grad on the CPU} of sum(img·w) + sum(z·wz) for a frame
    rendered on ``device``."""
    p, named = grad_params(params, device)
    img, z = make_renderer(static, cfg, resx, resy, device=device)(
        p, rng.PhiloxSampler(seed, device))
    ((img * w.to(device)).sum() + (z * wz.to(device)).sum()).backward()
    return {n: (x.grad if x.grad is not None else torch.zeros_like(x)).cpu()
            for n, x in named}


def grads_agree(card, cpu, what: str) -> tuple[str, float]:
    """Card grads against CPU grads, leaf by leaf (GRAD_RTOL,
    GRAD_MAX_RTOL).  Returns the leaf with the largest max |diff| / scale,
    and that ratio."""
    worst = ("", 0.0)
    for name, b in cpu.items():
        a = card[name]
        check(bool(torch.isfinite(a).all()), f"{what} {name}: finite")
        ref = GRAD_SCALE_OF.get(name, name)
        scale = max(card[ref].abs().max().item() if card[ref].numel() else 0,
                    cpu[ref].abs().max().item() if cpu[ref].numel() else 0)
        if not a.numel():
            continue
        diff = (a - b).abs()
        err = diff.max().item()
        check(err <= GRAD_MAX_RTOL * scale,
              f"{what} {name}: max |card - cpu| {err} > {GRAD_MAX_RTOL} x "
              f"{scale}")
        if a.numel() >= 1000:
            frac = (diff <= GRAD_RTOL * scale).float().mean().item()
            check(frac >= 0.999, f"{what} {name}: {frac:.5f} of entries "
                                 f"within {GRAD_RTOL} x {scale}")
        if scale and err / scale > worst[1]:
            worst = (name, err / scale)
    return worst


def time_fwd_bwd(render, params, device, seed, launch_fns, warmup=True,
                 finite=True):
    """One warm-up forward+backward step of mean(img²) over every leaf
    (unless ``warmup`` is False: the path's forward frames already ran),
    then one timed step; with ``finite`` the grads must be finite (False
    where the frame holds a non-finite pixel, so that the loss is inf).
    Returns (seconds, forward stats, launches in the timed step, peak
    bytes, named leaves)."""
    p, named = grad_params(params, device)

    def step():
        for _, x in named:
            x.grad = None
        img, _, st = render(p, rng.PhiloxSampler(seed, device))
        img.square().mean().backward()
        return st

    if warmup:
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for fn in launch_fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    st = step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launch_fns.items()}
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check(any(x.grad is not None for _, x in named), "fwd+bwd grads")
    if finite:
        for name, x in named:
            check(x.grad is None or bool(torch.isfinite(x.grad).all()),
                  f"fwd+bwd grad {name} finite")
        check(any(x.grad is not None and bool(x.grad.abs().max() > 0)
                  for _, x in named), "fwd+bwd grads nonzero")
    return (secs, {k: float(v) for k, v in st.items()}, launches,
            torch.cuda.max_memory_allocated(device), named)


def with_lights(sc, n: int):
    """The scene's static with every emitter at ``n`` light samples."""
    return dataclasses.replace(sc.static, num_lights=tuple(
        n if k else 0 for k in sc.static.num_lights))


def check_frame(img, z, res, what: str) -> None:
    check(tuple(img.shape) == (res, res, 3) and tuple(z.shape) == (res, res),
          f"{what} shapes")
    check(bool(torch.isfinite(img).all()) and img.max().item() > 0,
          f"{what} image finite and lit")
    check(bool((z > 0).any()) and bool((z == 0).any()),
          f"{what} z has hits and misses")


def cap_lights(sc, n: int):
    """The scene's static with every emitter at most ``n`` light samples
    (bench.py's flagship caps scene5's lights at 24)."""
    return dataclasses.replace(sc.static, num_lights=tuple(
        min(k, n) for k in sc.static.num_lights))


def stats_equal(a: dict, b: dict, what: str) -> None:
    for k in b:
        check(a[k] == b[k], f"{what} {k}: card {a[k]} cpu {b[k]}")


def worst_pixel(a, b) -> tuple[float, float, tuple]:
    """Card image ``a`` against CPU image ``b``: (share of pixels within
    1e-4·max, the largest |diff| over max, its (row, col))."""
    diff = (a - b).abs().amax(-1) / b.max()
    share = (diff <= 1e-4).float().mean().item()
    at = divmod(int(diff.argmax()), diff.shape[1])
    return share, diff.max().item(), at


def nonfinite_tiles_agree(static, params, cfg, img, seed) -> list:
    """The non-finite pixels of a card frame, each reproduced on the CPU.

    Under path GI the reference's arithmetic can overflow: its sphere and
    reflection normals are not renormalised, so at a grazing hit a GI
    child's direction can leave unit length by a few percent, the sphere
    test (which takes |d| = 1) then puts the child's hit off the surface
    with a normal of length ~2.7, and the specular powf of 200 light
    samples passes FLT_MAX (the reference saturates such a pixel when it
    quantizes).  At most 1e-5 of the pixels may be non-finite, and each
    tile that holds one is rendered again on the CPU: the same pixels must
    be non-finite there, and the tile's finite pixels within 1e-4·max.
    Returns the non-finite pixels' (row, col)."""
    resy, resx = img.shape[:2]
    bad = ~torch.isfinite(img).all(-1).cpu()
    n_bad = int(bad.sum())
    check(n_bad <= 1e-5 * resx * resy, f"{n_bad} non-finite pixels")
    if not n_bad:
        return []
    # one tile on the CPU: the frame's tiling and draws (render/api.py)
    frame = api._Frame(static, cfg, resx, resy, "cpu")
    flat = bad.reshape(-1)
    with torch.no_grad():
        ix, o, d = frame.setup(params_to_torch(params, "cpu"), False)
        for t in sorted(set((flat.nonzero()[:, 0] // frame.tile).tolist())):
            rows = slice(t * frame.tile, (t + 1) * frame.tile)
            color, _ = frame.tiles(ix, o, d, rng.PhiloxSampler(seed, "cpu"),
                                   t, t + 1, False)
            card = img.reshape(-1, 3)[rows].cpu()
            fin = torch.isfinite(color).all(-1)
            check(torch.equal(~fin, flat[rows]),
                  f"tile {t}: the card's non-finite pixels on the CPU")
            scale = color[fin].abs().max()
            check(bool(((card[fin] - color[fin]).abs().amax(-1)
                        <= 1e-4 * scale).float().mean() >= 0.99),
                  f"tile {t}: finite pixels on the CPU")
    return [divmod(int(i), resx) for i in flat.nonzero()[:, 0]]


def capture_gi_chunk(static, params, cfg, device, seed):
    """The operands of kernel 2's first call at a GI child's hits (round 0,
    sample 0, chunk 0) in one 256x256 tile of the dense stand-in."""
    def keep(ckey, n_valid, statics, px, scal_f):
        if len(ckey.path) < 3 or ckey.path[2] != GI_TAG or ckey.path[-1]:
            return None
        u = ckey.uniform((2, statics["lc"], px.shape[1]))
        return u, px.clone(), scal_f.clone(), n_valid, dict(statics)

    calls = record(shading, "_fused_chunk", lambda: make_renderer(
        static, cfg, 256, 256, device=device)(
            params, rng.PhiloxSampler(seed, device)), keep)
    return calls[0]


def capture_gi_visit(static, params, cfg, res, device, seed):
    """The visit-order operands of the GI child traces of a frame's first
    round, in call order."""
    in_gi = [False]
    real = integrator._gi_sample

    def gi_sample(*a):
        in_gi[0] = True
        try:
            return real(*a)
        finally:
            in_gi[0] = False

    integrator._gi_sample = gi_sample
    try:
        return record(pallas_visit, "visit_order", lambda: make_renderer(
            static, dataclasses.replace(cfg, rounds=1), res, res,
            device=device)(params, rng.PhiloxSampler(seed, device)),
            lambda o, d, lo, hi, V, count_max_dist=None:
            (o.clone(), d.clone(), lo, hi, V) if in_gi[0] else None)
    finally:
        integrator._gi_sample = real


def flagship_loss(color, z, target):
    """bench.py's flagship pixel loss: Σ color² over the channels."""
    return (color * color).sum(-1)


def flagship_grads(static, params, res, device, seed):
    """{leaf name: grad on the CPU} of the flagship loss by the host-tiled
    value-and-grad on ``device``, at 1 bounce (the CPU's time)."""
    from c_raytracer_tpu_torch.scene import named_leaves
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_bounces=1)
    vg = make_host_tiled_value_and_grad(static, cfg, res, res,
                                        flagship_loss, device=device)
    _, g = vg(params, rng.PhiloxSampler(seed, device))
    return {n: x.cpu() for n, x in named_leaves(g)}


def gi_phases(sc, gsc, dev, seed, gen, n_sm, op_weights) -> dict:
    """Phases 19-23: path-traced GI and the host-tiled entry points
    (``op_weights``: phase 10's probe weights of kernel 2's operations).
    Returns the numbers for the kernels' JSON line."""
    cpu = torch.device("cpu")
    out = {"kernel_gi": collections.defaultdict(list), "launches": {}}

    # -- phase 19: dense 64x64 path GI, card against CPU ------------------
    fr = [render_on(d, sc.static, sc.params, GI_CFG, 64, seed)
          for d in (dev, cpu)]
    stats_equal(fr[0][2], fr[1][2], "dense 64x64 path GI")
    share, worst, at = worst_pixel(fr[0][0], fr[1][0])
    zok = ((fr[0][1] - fr[1][1]).abs() <= 1e-4 * fr[1][1].max()).float()
    check(share >= 0.99, f"dense GI image: {share:.5f} of pixels")
    check(zok.mean().item() >= 0.99, f"dense GI z: {zok.mean():.5f}")
    phase(19, f"dense 64x64, path GI spp 4: card vs CPU stats equal "
              f"{fr[0][2]}; image {share:.5f} of pixels within 1e-4·max, "
              f"worst pixel {at} at {worst:.3e}·max; z {zok.mean():.5f}")
    w = torch.rand((64, 64, 3), generator=torch.Generator().manual_seed(seed))
    wz = torch.zeros((64, 64))
    card = frame_grads(sc.static, sc.params, GI_CFG, 64, 64, dev, seed, w, wz)
    cpu_g = frame_grads(sc.static, sc.params, GI_CFG, 64, 64, cpu, seed, w,
                        wz)
    worst_g = grads_agree(card, cpu_g, "dense 64x64 path GI")
    phase(19, f"card vs CPU grads of sum(img·w), dense 64x64 path GI spp 4: "
              f"every leaf finite and within tolerance; worst leaf {worst_g}")

    # -- phase 20: glass 32x32 path GI card vs CPU; kernels at GI shapes ---
    gstatic20 = with_lights(gsc, 20)
    gcfg = RenderConfig(max_bounces=1, gi_model="path", samples_per_pixel=2)
    fr = [render_on(d, gstatic20, gsc.params, gcfg, 32, seed)
          for d in (dev, cpu)]
    stats_equal(fr[0][2], fr[1][2], "glass 32x32 path GI")
    check_frame(fr[0][0], fr[0][1], 32, "glass 32x32 path GI")
    share, worst, at = worst_pixel(fr[0][0], fr[1][0])
    check(share >= 0.99, f"glass GI image: {share:.5f} of pixels")
    phase(20, f"glass 32x32 (1 bounce, 20 lights), path GI spp 2: card vs "
              f"CPU stats equal {fr[0][2]}; image {share:.5f} of pixels "
              f"within 1e-4·max, worst pixel {at} at {worst:.3e}·max")
    key = rng.path_key(seed, (0, 0, GI_TAG, 0, 0))
    for shp in ((2, 65536), (2, 2048)):
        k = rng.philox_uniform(key, shp, device=dev)
        check(torch.equal(k, rng.philox_uniform_reference(key, shp,
                                                          device=dev)),
              f"philox bit-exact {shp}")
        lib_runs, dev_runs = paired(
            lambda: torch.rand(shp, generator=gen, device=dev),
            lambda: rng.philox_uniform(key, shp, device=dev), device_ms)
        out["kernel_gi"]["philox_uniform"].append(dict(time_line(
            f"philox hemisphere draw {shp}", dev_runs,
            bound_ms(4 * shp[0] * shp[1], 0), library_ms=mean(lib_runs)),
            shape=list(shp), plain_ms=device_ms(
                lambda: rng.philox_uniform_reference(key, shp, device=dev),
                10)))
    cu, cpx, csf, cnv, ckw = capture_gi_chunk(sc.static, sc.params, GI_CFG,
                                              dev, seed)
    err2 = compare_fused(cu, cpx, csf, cnv, ckw)
    P = cpx.shape[1]
    live = int((cpx[16] > 0).sum())
    samples = live * min(ckw["lc"], cnv)
    fb = fused_bound(samples, P, live, csf.numel(), ckw["ns"], ckw["npl"],
                     op_weights)

    def run2():
        return fused_shadow.fused_chunk(cu, cpx, csf, cnv, **ckw)

    dev_runs = [device_ms(run2), device_ms(run2)]
    out["kernel_gi"]["fused_shadow_chunk"].append(dict(time_line(
        f"fused chunk at GI child hits lc={ckw['lc']} P={P} ({live} live "
        f"pixels)", dev_runs, fb["bound"], ops_count="probe-weighted",
        datasheet_bound_ms=fb["datasheet_bound_ms"],
        datasheet_share=fb["datasheet_bound_ms"] / mean(dev_runs)),
        max_abs_err=err2, plain_ms=device_ms(
        lambda: fused_shadow.fused_chunk_reference(cu, cpx, csf, cnv, **ckw),
        10)))
    vcalls = capture_gi_visit(gstatic20, gsc.params, FLAGSHIP_CFG,
                              GLASS_RES, dev, seed)
    check(len(vcalls) >= 4, f"{len(vcalls)} GI child traces captured")
    co, cd, clo, chi, _ = vcalls[0]
    R_, K_ = co.shape[0], clo.shape[0]
    live = int((torch.isfinite(co).all(1) & torch.isfinite(cd).all(1)).sum())
    for v in GLASS_LISTS:
        n_ok, sp, err3 = compare_visit(co, cd, clo, chi, v)

        def run3(v=v):
            return pallas_visit.visit_order(co, cd, clo, chi, v)
        out["kernel_gi"]["visit_order"].append(dict(time_line(
            f"visit order GI child trace R={R_} K={K_} V={v} ({n_ok} ok "
            f"slots, spill max {sp})", [device_ms(run3), device_ms(run3)],
            bound_ms(4 * (6 * R_ + 6 * K_ + 2 * R_ * v + R_),
                     VISIT_OPS_PER_BOX * live * K_),
            split=str(pallas_visit.visit_split(R_, K_, v, n_sm))),
            V=v, spill_max=sp, ok_slots=n_ok, max_abs_err=err3,
            plain_ms=device_ms(lambda v=v: pallas_visit.visit_order_reference(
                co, cd, clo, chi, v), 10)))
    phase(20, "kernels 1-3 match their plain versions at the GI shapes: "
              "philox (2,65536) (2,2048) bit-exact; fused chunk at GI child "
              f"hits max |diff| {err2:.3e}; visit order of a GI child trace "
              f"bit-equal at V={GLASS_LISTS}")

    # -- phase 21: dense 1024x1024 path GI, frame and fwd+bwd -------------
    dense_fns = {"philox_uniform": rng.philox_uniform,
                 "fused_shadow_chunk": fused_shadow.fused_chunk}
    render = make_renderer(sc.static, GI_CFG, 1024, 1024, device=dev,
                           with_stats=True)
    img, z, st, secs, launches, peak = time_frames(
        render, sc.params, rng.PhiloxSampler(seed, dev), dev, dense_fns)
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    bad = nonfinite_tiles_agree(sc.static, sc.params, GI_CFG, img, seed)
    check_frame(torch.where(torch.isfinite(img), img, 0.0), z, 1024,
                "dense path GI 1024")
    check(st["gi_rays"] > 0, f"GI rays {st}")
    rays = st["main_rays"] + st["shadow_rays"] + st["gi_rays"]
    frame_s = mean(secs)
    out["launches"]["dense_gi_1024_3_frames"] = launches
    out["dense_gi"] = dict(frame_s=frame_s, frame_runs=secs, stats=st,
                           peak_mib=peak / 2**20)
    phase(21, f"1024x1024 stand-in, path GI spp 4: frame s "
              f"{[round(x, 6) for x in secs]} mean {frame_s:.6f}; "
              f"{rays / 2**20:.2f} rays/px; {rays / frame_s:.6e} rays/s; "
              f"peak {peak / 2**20:.1f} MiB; launches {launches} over 3 "
              f"frames; stats {st}; non-finite pixels (row, col) {bad}, "
              f"each the same on the CPU")
    del img, z
    torch.cuda.empty_cache()
    bsecs, _, blaunch, bpeak, _ = time_fwd_bwd(
        render, sc.params, dev, seed, dense_fns, warmup=False,
        finite=not bad)
    out["launches"]["dense_gi_1024_fwd_bwd"] = blaunch
    phase(21, f"path GI fwd+bwd, mean(img²) over every leaf (no warm-up "
              f"step): s {bsecs:.6f}; {bsecs / frame_s:.3f}x the forward; "
              f"peak {bpeak / 2**20:.1f} MiB; launches {blaunch}"
              + ("; grads not finite: the frame's loss is inf" if bad
                 else ""))
    del render
    torch.cuda.empty_cache()

    # -- phase 22: host-tiled renderer == make_renderer on the card --------
    hcfg = dataclasses.replace(GI_CFG, tile_size=20000)   # 4 tiles, padded
    ref = make_renderer(sc.static, hcfg, 256, 256, device=dev,
                        with_stats=True)(sc.params,
                                         rng.PhiloxSampler(seed, dev))
    for tpc in (1, 3):
        got = make_host_tiled_renderer(sc.static, hcfg, 256, 256, device=dev,
                                       tiles_per_call=tpc, with_stats=True)(
            sc.params, rng.PhiloxSampler(seed, dev))
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"host-tiled frame, tiles_per_call={tpc}")
        check({k: float(v) for k, v in got[2].items()}
              == {k: float(v) for k, v in ref[2].items()},
              f"host-tiled stats, tiles_per_call={tpc}")
    phase(22, "host-tiled renderer equals make_renderer bit for bit: dense "
              "256x256, path GI spp 4, tiles of 20,000 px (4, the last "
              "padded), tiles_per_call 1 and 3; image, z and stats")

    # -- phase 23: the flagship, glass 64x64 path GI host-tiled -----------
    fstatic = cap_lights(gsc, FLAGSHIP_LIGHTS)
    glass_fns = {"philox_uniform": rng.philox_uniform,
                 "visit_order": pallas_visit.visit_order}
    hrender = make_host_tiled_renderer(fstatic, FLAGSHIP_CFG, GLASS_RES,
                                       GLASS_RES, device=dev,
                                       with_stats=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in glass_fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    img, z, fst = hrender(gsc.params, rng.PhiloxSampler(seed, dev))
    torch.cuda.synchronize()
    fsecs = time.perf_counter() - t0
    flaunch = {k: fn.launches for k, fn in glass_fns.items()}
    fpeak = torch.cuda.max_memory_allocated(dev)
    check(all(n > 0 for n in flaunch.values()), f"launches {flaunch}")
    check_frame(img, z, GLASS_RES, "flagship frame")
    fst = {k: float(v) for k, v in fst.items()}
    frays = fst["main_rays"] + fst["shadow_rays"] + fst["gi_rays"]
    out["launches"]["flagship_frame"] = flaunch
    phase(23, f"flagship: glass {GLASS_RES}x{GLASS_RES}, 24 lights, "
              f"{FLAGSHIP_BOUNCES} bounces, path GI "
              f"spp 4, light_chunk 8, host-tiled (2 batches of the auto "
              f"tile 2048), one frame: s {fsecs:.6f}; {frays:.0f} rays, "
              f"{frays / fsecs:.6e} rays/s; peak {fpeak / 2**20:.1f} MiB; "
              f"launches {flaunch}; spill max shadow "
              f"{fst['shadow_spill_max']:.0f} visit "
              f"{fst['visit_spill_max']:.0f}; stats {fst}")
    del img, z
    vg = make_host_tiled_value_and_grad(fstatic, FLAGSHIP_CFG, GLASS_RES,
                                        GLASS_RES, flagship_loss, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in glass_fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    loss, grads = vg(gsc.params, rng.PhiloxSampler(seed, dev))
    torch.cuda.synchronize()
    vsecs = time.perf_counter() - t0
    vlaunch = {k: fn.launches for k, fn in glass_fns.items()}
    vpeak = torch.cuda.max_memory_allocated(dev)
    check(all(n > 0 for n in vlaunch.values()), f"launches {vlaunch}")
    from c_raytracer_tpu_torch.scene import named_leaves
    gl = named_leaves(grads)
    check(all(bool(torch.isfinite(g).all()) for _, g in gl)
          and any(bool(g.abs().max() > 0) for _, g in gl if g.numel()),
          "flagship grads finite and live")
    out["launches"]["flagship_value_and_grad"] = vlaunch
    out["flagship"] = dict(frame_s=fsecs, frame_peak_mib=fpeak / 2**20,
                           frame_stats=fst, step_s=vsecs,
                           step_peak_mib=vpeak / 2**20, loss=loss)
    phase(23, f"flagship host-tiled value-and-grad, one step: s "
              f"{vsecs:.6f} ({vsecs / fsecs:.3f}x the frame); loss "
              f"{loss:.6e}; peak {vpeak / 2**20:.1f} MiB; launches "
              f"{vlaunch}")
    del grads, vg, hrender
    torch.cuda.empty_cache()
    card = flagship_grads(fstatic, gsc.params, FLAGSHIP_GRAD_RES, dev, seed)
    cpu_g = flagship_grads(fstatic, gsc.params, FLAGSHIP_GRAD_RES, cpu, seed)
    worst = grads_agree(card, cpu_g, f"flagship {FLAGSHIP_GRAD_RES}x"
                                     f"{FLAGSHIP_GRAD_RES}")
    phase(23, f"flagship card vs CPU grads at {FLAGSHIP_GRAD_RES}x"
              f"{FLAGSHIP_GRAD_RES} (1 bounce), every "
              f"leaf finite and within tolerance; worst leaf {worst}")
    return out


BIG_LISTS = (384, 512, 1024)   # kernel 3 above 256: passes of 256
CLI_RES = 1024                 # the engine's and postprocess's frame


def big_list_phase(mesh, glass, glass_rec, gsc, dev, gen, n_sm, seed):
    """Phase 24: kernel 3 at V = 384, 512 and 1024 (passes of 256) on the
    mesh and glass stand-ins' boxes, bit-equal to the plain version on
    aimed rays with and without count_max_dist and on boxes grown so that
    every ray overlaps more than 1024 of them; device ms on the main
    path's first-round rays beside V = 256, and the launches of a glass
    frame at bvh_visits=512.  Returns the V = 512 record."""
    checks = {}
    timing = {}
    err = 0.0
    for name, (o1, d1, lo, hi) in (("mesh", mesh), ("glass", glass)):
        K = lo.shape[0]
        o, d = aimed_rays(lo, hi, MESH_TILE, gen)
        o, d = o.contiguous(), d.contiguous()
        cmd = torch.rand((MESH_TILE,), generator=gen, device=dev) * 4
        grow = 0.5 * (hi.max(0).values - lo.min(0).values)
        lo_f, hi_f = (lo - grow).contiguous(), (hi + grow).contiguous()
        n_f = int((pallas_visit.visit_order_reference(
            o, d, lo_f, hi_f, 1)[2] + 1).min())
        check(n_f > max(BIG_LISTS), f"{name} grown boxes: every ray "
                                    f"overlaps {n_f} > {max(BIG_LISTS)}")
        for v in BIG_LISTS + (K,):
            got = [compare_visit(o, d, lo, hi, v),
                   compare_visit(o, d, lo, hi, v, cmd),
                   compare_visit(o, d, lo_f, hi_f, v)]
            checks[(name, v)] = [(r[0], r[1]) for r in got]
            err = max([err] + [r[2] for r in got])
        live = int((torch.isfinite(o1).all(1) & torch.isfinite(d1).all(1))
                   .sum())
        for v in (256,) + BIG_LISTS:
            def run(v=v, o1=o1, d1=d1, lo=lo, hi=hi):
                return pallas_visit.visit_order(o1, d1, lo, hi, v)
            passes = len(pallas_visit.visit_passes(v))
            rec = time_line(
                f"visit order {name} first round R={MESH_TILE} K={K} V={v} "
                f"({passes} passes)",
                [pass_ms(run, v), pass_ms(run, v)],
                bound_ms(4 * (6 * MESH_TILE + 6 * K + 2 * MESH_TILE * v
                              + MESH_TILE), VISIT_OPS_PER_BOX * live * K),
                split=str(pallas_visit.visit_split(MESH_TILE, K, v, n_sm)))
            rec["plain_ms"] = device_ms(
                lambda v=v, o1=o1, d1=d1, lo=lo, hi=hi:
                pallas_visit.visit_order_reference(o1, d1, lo, hi, v), 10)
            timing[(name, v)] = rec
    # a glass frame at bvh_visits=512 (20 light samples: the closest-hit
    # calls do not depend on the count) for its launches a frame
    pallas_visit.visit_order.launches = 0
    make_renderer(with_lights(gsc, 20), RenderConfig(bvh_visits=512),
                  GLASS_LAUNCH_RES, GLASS_LAUNCH_RES, device=dev)(
        gsc.params, rng.PhiloxSampler(seed, dev))
    torch.cuda.synchronize()
    n512 = pallas_visit.visit_order.launches
    check(n512 > 0 and n512 % 2 == 0, f"V=512 frame launches {n512}")
    phase(24, f"visit-order kernel bit-equal to plain above 256 (ok slots, "
              f"spill max) for aimed rays, with count_max_dist, and grown "
              f"boxes (every ray > {max(BIG_LISTS)} overlaps): "
              f"{ {f'{k[0]} V={k[1]}': c for k, c in checks.items()} }")
    phase(24, "device ms / bound ms / plain ms, first-round rays: " + "; ".join(
        f"{k[0]} V={k[1]} {r['device_ms']:.6f} / {r['bound_ms']:.6f} / "
        f"{r['plain_ms']:.6f}" for k, r in timing.items())
        + f"; glass V=256 in phase 14: {glass_rec[256]['device_ms']:.6f}; "
        f"launches of a glass {GLASS_LAUNCH_RES}x{GLASS_LAUNCH_RES} frame "
        f"at bvh_visits=512: {n512} (2 passes a call)")
    rec = dict(timing[("glass", 512)], launches_per_frame=n512,
               max_abs_err=err,
               mesh_device_ms=timing[("mesh", 512)]["device_ms"],
               by_v={f"{k[0]} V={k[1]}": {x: r[x] for x in (
                   "device_ms", "bound_ms", "plain_ms")}
                   for k, r in timing.items()})
    return rec


def run_cli(module: str, args, what: str):
    """``python -m <module> <args>`` from the repository root on the
    default device: (wall seconds, its log lines); a non-zero exit
    raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}\n"
                                f"{proc.stdout}\n{proc.stderr}")
    return secs, proc.stderr.strip().splitlines()


def engine_in_process(args):
    """The engine CLI's ``main`` in this process, its log captured: (exit
    code, log lines, launches by kernel, wall seconds)."""
    from c_raytracer_tpu_torch.cli import engine
    fns = {"philox_uniform": rng.philox_uniform,
           "fused_shadow_chunk": fused_shadow.fused_chunk,
           "visit_order": pallas_visit.visit_order}
    for fn in fns.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        rc = engine.main([str(a) for a in args])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (rc, buf.getvalue().strip().splitlines(),
            {k: fn.launches for k, fn in fns.items()}, secs)


def log_value(lines, pattern: str, what: str):
    """The first match of ``pattern`` in the log lines."""
    for line in lines:
        m = re.search(pattern, line)
        if m:
            return m
    check(False, f"{what}: no log line matches {pattern!r}")


def spill_of(lines) -> dict:
    """The spill maxima the engine's guard reported (0 when silent)."""
    out = {"shadow": 0.0, "visit": 0.0}
    for line in lines:
        m = re.search(r"WARNING: (shadow|closest-hit) visit budget EXCEEDED "
                      r"by up to (\d+)", line)
        if m:
            out["shadow" if m.group(1) == "shadow" else "visit"] = float(
                m.group(2))
    return out


def engine_phase(sc, dev, tmp):
    """Phase 25: the engine CLI as a user runs it, on the default device:
    the dense stand-in at 1024x1024, raw and 8-bit, against the
    in-process frame.  Returns the frame (image, z) on the card."""
    from c_raytracer_tpu_torch.image import (quantize_rgb8, read_tiff,
                                             write_tiff_rgb8)
    raw = f"{tmp}/engine_raw.tif"
    out8 = f"{tmp}/engine_8bit.tif"
    secs, lines = run_cli("c_raytracer_tpu_torch.cli.engine",
                          [SCENE, raw, CLI_RES, CLI_RES, "-f", "--stats"],
                          "engine -f")
    for line in lines:
        print(f"[phase 25] engine: {line}", flush=True)
    launches = log_value(lines, r"Kernel launches: (.*)\.", "launches")
    check(all(int(n) > 0 for n in re.findall(
        r"(?:philox_uniform|fused_shadow_chunk) (\d+)", launches.group(1))),
        f"engine launches {launches.group(1)}")
    secs8, lines8 = run_cli("c_raytracer_tpu_torch.cli.engine",
                            [SCENE, out8, CLI_RES, CLI_RES], "engine 8-bit")
    img, z = make_renderer(sc.static, RenderConfig(), CLI_RES, CLI_RES,
                           device=dev)(sc.params, rng.PhiloxSampler(0, dev))
    torch.cuda.synchronize()
    got, gz = read_tiff(raw)
    img_np, z_np = img.cpu().numpy(), z.cpu().numpy()
    check(got.tobytes() == img_np.tobytes(), "engine raw image == frame")
    check(gz.tobytes() == z_np.reshape(-1).tobytes(), "engine raw z == frame")
    want8 = f"{tmp}/want_8bit.tif"
    write_tiff_rgb8(want8, img_np)
    with open(out8, "rb") as f, open(want8, "rb") as g:
        check(f.read() == g.read(), "engine 8-bit file == quantize(frame)")
    q = quantize_rgb8(img_np)
    frame_s = float(log_value(lines, r"in ([0-9.]+)s:", "frame s").group(1))
    t_end = float(lines[-1][1:9])
    phase(25, f"engine {SCENE} {CLI_RES}x{CLI_RES} -f --stats as a "
              f"subprocess on the default device: exit 0, wall s "
              f"{secs:.6f}: {secs - t_end:.3f} s before its log starts "
              f"(python, the torch import), the frame {frame_s} s by its "
              f"log, saving to terminating "
              f"{t_end - float(lines[-2][1:9]):.3f} s; raw "
              f"image and z bit-equal to the in-process frame; 8-bit run "
              f"wall s {secs8:.6f}, its file byte-equal to quantize_rgb8 of "
              f"the frame ({int((q == 255).sum())} channels at 255)")
    return img, z, raw


def progressive_phase(sc, dev, tmp):
    """Phase 26: a checkpointed progressive render of the dense stand-in
    at 1024x1024, stopped after 2 of 4 chunks and resumed, against the
    uninterrupted render; the spp-chunked dense GI frame at 256x256
    against the single call."""
    import numpy as np

    from c_raytracer_tpu_torch.image import write_tiff_raw
    from c_raytracer_tpu_torch.render import (render_progressive,
                                              render_spp_chunked)
    fns = {"philox_uniform": rng.philox_uniform,
           "fused_shadow_chunk": fused_shadow.fused_chunk}
    cfg = RenderConfig()
    ck = f"{tmp}/progressive.tif"

    def timed(**kw):
        stamps = [time.perf_counter()]

        def log(msg, *a):
            if msg.startswith("Progressive chunk"):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
        out = render_progressive(sc, cfg, CLI_RES, CLI_RES,
                                 rng.PhiloxSampler(0, dev), device=dev,
                                 chunks=4, log=log, **kw)
        return out, [b - a for a, b in zip(stamps, stamps[1:])]

    for fn in fns.values():
        fn.launches = 0
    (full, full_z), full_s = timed()
    (_, _), part_s = timed(checkpoint=ck, resume=False, _stop_after=2)
    (resumed, rz), resume_s = timed(checkpoint=ck, resume=True)
    launches = {k: fn.launches for k, fn in fns.items()}
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check(len(resume_s) == 2, f"resumed {len(resume_s)} chunks")
    check(bool(np.isfinite(full).all()) and full.max() > 0,
          "progressive frame finite and lit")
    rel = np.abs(resumed - full) / np.maximum(np.abs(full), 1e-30)
    rel = float(np.where(full == resumed, 0.0, rel).max())
    check(rel <= 1e-6, f"resumed vs uninterrupted: relative {rel}")
    check(np.array_equal(rz, full_z), "resumed z")
    wsecs = []
    for _ in range(3):
        t0 = time.perf_counter()
        write_tiff_raw(ck, full, full_z)
        wsecs.append(time.perf_counter() - t0)
    phase(26, f"progressive {CLI_RES}x{CLI_RES} stand-in, 4 chunks: s a "
              f"chunk {[round(x, 6) for x in full_s]} uninterrupted, "
              f"{[round(x, 6) for x in part_s]} with the checkpoint "
              f"(stopped after 2), {[round(x, 6) for x in resume_s]} "
              f"resumed; raw TIFF checkpoint write s "
              f"{[round(x, 6) for x in wsecs]}; resumed vs uninterrupted: "
              f"largest relative difference {rel:.3e} (gate 1e-6), z equal; "
              f"launches {launches}")
    single = make_renderer(sc.static, GI_CFG, 256, 256, device=dev)(
        sc.params, rng.PhiloxSampler(0, dev))[0].cpu()
    for fn in fns.values():
        fn.launches = 0
    chunked, _ = render_spp_chunked(sc, GI_CFG, 256, 256,
                                    rng.PhiloxSampler(0, dev), device=dev,
                                    spp_chunks=2)
    launches = {k: fn.launches for k, fn in fns.items()}
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    chunked = torch.from_numpy(chunked)
    fin = torch.isfinite(single)
    check(torch.equal(fin, torch.isfinite(chunked)), "spp chunks: finite")
    err = ((chunked[fin] - single[fin]).abs()
           / (1e-6 + 1e-4 * single[fin].abs())).max().item()
    check(err <= 1.0, f"spp chunks vs single call: {err} of rtol 1e-4")
    phase(26, f"render_spp_chunked dense 256x256 path GI spp 4 in 2 chunks "
              f"equals the single call within rtol 1e-4 / atol 1e-6 (worst "
              f"{err:.3f} of the tolerance; {int((~fin).sum())} non-finite "
              f"channels in both); launches {launches}")


def accel_phase(msc, gsc, mesh_default, glass_default, dev, tmp, n_sm):
    """Phase 27: --accel-report on the mesh stand-in at 512x512 and
    --accel-tune on the glass stand-in at 64x64 through the engine's main
    in this process; the card's reports at 64x64 against the CPU's."""
    rc, lines, mlaunch, _ = engine_in_process(
        [MESH_SCENE, f"{tmp}/mesh.tif", MESH_RES, MESH_RES, "--accel-report",
         "--stats", "--device", "cuda"])
    check(rc == 0, f"engine --accel-report exit {rc}")
    for line in lines:
        print(f"[phase 27] engine mesh: {line}", flush=True)
    m = log_value(lines, r"^\[([0-9.]+)\].*Accel spill report: (.*)\.$",
                  "report")
    mrep = ast.literal_eval(m.group(2))
    t_bvh = float(log_value(lines, r"^\[([0-9.]+)\].*Generating the BVH",
                            "bvh").group(1))
    mframe = float(log_value(lines, r"in ([0-9.]+)s:", "frame").group(1))
    check(mlaunch["visit_order"] > 0 and mlaunch["philox_uniform"] > 0,
          f"mesh launches {mlaunch}")
    phase(27, f"mesh {MESH_RES}x{MESH_RES} --accel-report: report s "
              f"{float(m.group(1)) - t_bvh:.3f}; {mrep}; frame s at the "
              f"default budgets {mframe} (phase 9: {mesh_default[0]:.6f}), "
              f"spill {spill_of(lines)} (phase 9: {mesh_default[1]}); "
              f"launches {mlaunch}")
    rc, lines, glaunch, _ = engine_in_process(
        [GLASS_SCENE, f"{tmp}/glass.tif", GLASS_RES, GLASS_RES,
         "--accel-tune", "--stats", "--device", "cuda"])
    check(rc == 0, f"engine --accel-tune exit {rc}")
    for line in lines:
        print(f"[phase 27] engine glass: {line}", flush=True)
    t = log_value(lines, r"Accel auto-tune: visits=(\d+) shadow_visits=(\d+) "
                         r"shortlist=(\d+)", "tune")
    v, sv = int(t.group(1)), int(t.group(2))
    grep = ast.literal_eval(log_value(lines, r"Accel spill report: (.*)\.$",
                                      "report").group(1))
    gframe = float(log_value(lines, r"in ([0-9.]+)s:", "frame").group(1))
    K = grep["n_clusters"]
    split = pallas_visit.visit_split(MESH_TILE, K, v, n_sm)
    check(glaunch["visit_order"] > 0, f"glass launches {glaunch}")
    phase(27, f"glass {GLASS_RES}x{GLASS_RES} (100 lights) --accel-tune: "
              f"report {grep}; tuned visits {v}, shadow visits {sv}; frame "
              f"s at the tuned budgets {gframe} (phase 16, defaults: "
              f"{glass_default[0]:.6f}); spill at the tuned budgets "
              f"{spill_of(lines)} (defaults: {glass_default[1]}); kernel 3 "
              f"at V={v}: list {split.vm}, {split.passes} pass(es) a call, "
              f"{glaunch['visit_order']} launches; launches {glaunch}")
    from c_raytracer_tpu_torch.accel.validate import spill_report
    side = {}
    for name, scene in (("mesh", msc), ("glass", gsc)):
        card, cpu = (spill_report(scene, RenderConfig(), 64, 64, device=d)
                     for d in (dev, torch.device("cpu")))
        check(card["closest"] == cpu["closest"],
              f"{name} 64x64 closest counts: card {card['closest']} cpu "
              f"{cpu['closest']}")
        for a, b in zip(card["shadow"], cpu["shadow"]):
            for k in ("cluster_spill_pixels", "tri_spill_pixels"):
                check(abs(a[k] - b[k]) <= 1e-3 * 64 * 64,
                      f"{name} 64x64 shadow {k}: card {a[k]} cpu {b[k]}")
        side[name] = [{k: (a[k], b[k]) for k in a if k.endswith(
            ("_max", "_pixels"))} for a, b in zip(card["shadow"],
                                                  cpu["shadow"])]
    phase(27, f"spill reports at 64x64, card vs CPU: closest counts equal; "
              f"shadow (card, cpu) {side}")
    return dict(mesh_report=mrep, glass_report=grep, tuned=(v, sv),
                glass_tuned_frame_s=gframe)


def postprocess_phase(img, z, raw, dev, tmp):
    """Phase 28: the postprocess CLI on phase 25's raw file on the card,
    against the same command on the CPU; depth_of_field alone; the
    reference goldens computed on the card."""
    import numpy as np

    from c_raytracer_tpu_torch.image import quantize_rgb8, read_tiff
    from c_raytracer_tpu_torch.postprocess import ops
    zf = z[z > 0]
    focus = float(zf.median())
    scale = 17.0 / float((z - focus).abs().max())
    bias = -scale * focus
    r_max = int(ops.coc_radius(z, scale, bias).max())
    check(r_max >= 8, f"largest CoC radius {r_max}")
    start, depth = 0.5 * focus, float(zf.max() - zf.min())
    flags = ["-b", "1.5", "--dof", repr(scale), repr(bias), "--mist",
             repr(start), repr(depth), "lin", "0.5", "0.6", "0.7"]
    secs, lines = run_cli("c_raytracer_tpu_torch.cli.postprocess",
                          [raw, f"{tmp}/pp_card.tif", *flags], "postprocess")
    for line in lines:
        print(f"[phase 28] postprocess: {line}", flush=True)
    cpu_secs, _ = run_cli("c_raytracer_tpu_torch.cli.postprocess",
                          [raw, f"{tmp}/pp_cpu.tif", *flags, "--device",
                           "cpu"], "postprocess --device cpu")
    a, _ = read_tiff(f"{tmp}/pp_card.tif")
    b, _ = read_tiff(f"{tmp}/pp_cpu.tif")
    diff = np.abs(np.round(a * 255) - np.round(b * 255)).max(-1)
    share = float((diff <= 1).mean())
    check(share >= 0.999, f"postprocess card vs CPU: {share} within 1")
    bright = ops.brighten(img, 1.5)
    dof_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.depth_of_field(bright, z, scale, bias)
        torch.cuda.synchronize()
        dof_s.append(time.perf_counter() - t0)
    phase(28, f"postprocess -b 1.5 --dof {scale:.6g} {bias:.6g} --mist on "
              f"the {CLI_RES}x{CLI_RES} raw file: largest CoC radius "
              f"{r_max} px ({len(ops.disc_offsets(r_max))} offsets); card "
              f"wall s {secs:.6f}, CPU wall s {cpu_secs:.6f}; 8-bit card vs "
              f"CPU {share:.6f} of pixels within 1 (max {diff.max():.0f}); "
              f"depth_of_field alone on the card s "
              f"{[round(x, 6) for x in dof_s]}")

    def raw_on_card(name):
        im, zz = read_tiff(f"{REPO}/tests/goldens/{name}")
        return (torch.from_numpy(im).to(dev),
                torch.from_numpy(zz.reshape(im.shape[:2])).to(dev))

    def golden(name):
        im, _ = read_tiff(f"{REPO}/tests/goldens/{name}")
        return (im * 255.0).astype(np.int32)

    def q8(x):
        return quantize_rgb8(x.cpu().numpy()).astype(np.int32)

    im1, z1 = raw_on_card("scene1_96_raw.tif")
    im3, z3 = raw_on_card("scene3_96_raw.tif")
    s3, b3 = ops.dof_camera_params(z3, 0.1, 0.2, 3.0)
    res = {}
    for name, out in (
            ("pp_brighten.tif", ops.brighten(im1, 2.5)),
            ("pp_mist.tif", ops.mist(im1, z1, 2.0, 10.0, "lin",
                                     [0.5, 0.6, 0.7])),
            ("pp_dof.tif", ops.depth_of_field(ops.brighten(im1, 2.0), z1,
                                              0.02, -1.0)),
            ("pp_dof_camera.tif", ops.depth_of_field(im3, z3, s3, b3))):
        diff = np.abs(q8(out) - golden(name))
        res[name] = (float((diff.max(-1) <= 1).mean()), int(diff.max()))
    check(res["pp_brighten.tif"][1] == 0, f"pp_brighten {res}")
    check(res["pp_dof_camera.tif"][1] == 0, f"pp_dof_camera {res}")
    check(res["pp_mist.tif"][0] > 0.999 and res["pp_mist.tif"][1] <= 2,
          f"pp_mist {res}")
    check(res["pp_dof.tif"][0] > 0.995, f"pp_dof {res}")
    phase(28, f"reference goldens on the card (share of pixels within 1, "
              f"max diff): {res}")


SUPER_G = 16               # phase 29: supers of 16 mesh clusters
SUPER_SELS = (16, 48)      # supers kept per ray
COMPACT_TILE = 16384       # phase 30: tiles of 16384 rays,
COMPACT_BLOCK = 8192       # two compaction blocks of 8192 each
OPT_RES = 256              # phases 29, 30, 32: the timed mesh frames
REMAT_RES = 32             # phase 31: phase 18's glass step at 1/4 the px
REMAT_BOUNCES = 3          # and cut to 3 bounces
# the default names and all three (the two single names are left out to
# make room for phases 32-34; PERF.md holds their measurements)
REMAT_NAMES = (("occlusion",),
               ("occlusion", "shadow_samples", "shade_terms"))


def timed_frame(render, params, dev, seed):
    """One frame on the card: (seconds, image, z, stats, visit-order
    launches), the launch count set to 0 just before it."""
    pallas_visit.visit_order.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, z, st = render(params, rng.PhiloxSampler(seed, dev))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (secs, img, z, {k: float(v) for k, v in st.items()},
            pallas_visit.visit_order.launches)


def super_phase(msc, o1, d1, dev, gen, n_sm, seed) -> dict:
    """Phase 29: the two-level visit order (bvh_super_group).  Kernel 3 at
    the super level's shape (phase 7's first-round rays against the mesh
    stand-in's 535 supers of 16 clusters) bit-equal to its plain version
    at S = 16 and 48, with and without count_max_dist, and timed; a 64x64
    super frame card vs CPU; a 128x128 frame with every super kept against
    the dense order at bvh_visits=256; frame seconds of the 256x256 mesh
    stand-in at the defaults and at S = 16 and 48, in turns.  Returns the
    numbers for the kernels' JSON line."""
    from c_raytracer_tpu_torch.accel import traverse
    cpu = torch.device("cpu")
    cs = make_intersector(device_scene(params_to_torch(msc.params, dev),
                                       msc.static), msc.static,
                          RenderConfig()).clusters
    K, R = cs.lo.shape[0], o1.shape[0]
    Ks = -(-K // SUPER_G)
    boxes = record(pallas_visit, "visit_order",
                   lambda: traverse._visit_order_super(
                       cs, o1, d1, 16, SUPER_G, max(SUPER_SELS)),
                   lambda o, d, lo, hi, V, count_max_dist=None: (lo, hi))
    slo, shi = boxes[0]
    check(len(boxes) == 1 and slo.shape[0] == Ks == 535,
          f"super level: {len(boxes)} calls, K'={slo.shape[0]}")
    cmd = torch.rand((R,), generator=gen, device=dev) * 4
    live = int((torch.isfinite(o1).all(1) & torch.isfinite(d1).all(1)).sum())
    recs, oks = {}, {}
    for S in SUPER_SELS:
        oks[S] = [compare_visit(o1, d1, slo, shi, S)[:2],
                  compare_visit(o1, d1, slo, shi, S, cmd)[:2]]

        def run(S=S):
            return pallas_visit.visit_order(o1, d1, slo, shi, S)
        rec = time_line(
            f"visit order super level R={R} K'={Ks} V={S}",
            [device_ms(run), device_ms(run)],
            bound_ms(4 * (6 * R + 6 * Ks + 2 * R * S + R),
                     VISIT_OPS_PER_BOX * live * Ks),
            split=str(pallas_visit.visit_split(R, Ks, S, n_sm)))
        rec["plain_ms"] = device_ms(
            lambda S=S: pallas_visit.visit_order_reference(o1, d1, slo, shi,
                                                           S), 10)
        # the whole two-level order of a closest-hit call (CUDA events)
        rec["order_ms"] = issue_ms(lambda S=S: traverse._visit_order_super(
            cs, o1, d1, 16, SUPER_G, S))
        recs[S] = rec
    dense_ms = issue_ms(lambda: traverse._visit_order(cs, o1, d1, 16))
    phase(29, f"visit-order kernel bit-equal to plain at the super level, "
              f"R={R} K'={Ks} (ok slots, spill max; plain, count_max_dist): "
              f"{oks}; device ms / bound ms / plain ms "
              + "; ".join(f"S={S} {r['device_ms']:.6f} / {r['bound_ms']:.6f}"
                          f" / {r['plain_ms']:.6f}" for S, r in recs.items())
              + "; a closest-hit call's whole visit order ms (CUDA events, "
              f"20 calls): dense {dense_ms:.4f}, "
              + ", ".join(f"super S={S} {r['order_ms']:.4f}"
                          for S, r in recs.items()))

    scfg = RenderConfig(bvh_super_group=SUPER_G)
    fr = [render_on(d, msc.static, msc.params, scfg, 64, seed)
          for d in (dev, cpu)]
    stats_equal(fr[0][2], fr[1][2], "64x64 mesh super")
    pix, zok = frames_agree(*fr, "64x64 mesh super")
    full = [render_on(dev, msc.static, msc.params,
                      RenderConfig(bvh_visits=256, **kw), 128, seed)
            for kw in ({}, dict(bvh_super_group=SUPER_G, bvh_super_sel=Ks))]
    stats_equal(full[1][2], full[0][2], "128x128 super S=Ks vs dense")
    same = (full[0][0] == full[1][0]).all(-1) & (full[0][1] == full[1][1])
    n_diff = int((~same).sum())
    check(same.float().mean().item() >= 0.999,
          f"128x128 super S=Ks vs dense: {n_diff} pixels differ")
    phase(29, f"64x64 mesh at bvh_super_group={SUPER_G}, card vs CPU: stats "
              f"equal {fr[0][2]}; image {pix:.5f}, z {zok:.5f} of pixels "
              f"within 1e-4·max; 128x128 at bvh_visits=256, S={Ks} (every "
              f"super) vs the dense order: stats equal {full[0][2]}, "
              f"{n_diff} of {128 * 128} pixels differ (ties in t between "
              f"clusters: the super order visits the nearer super first)")
    del fr, full

    renders = {name: make_renderer(msc.static, cfg, OPT_RES, OPT_RES,
                                   device=dev, with_stats=True)
               for name, cfg in (
                   ("default", RenderConfig()),
                   ("S=16", scfg),
                   ("S=48", RenderConfig(bvh_super_group=SUPER_G,
                                         bvh_super_sel=48)))}
    runs = collections.defaultdict(list)
    for name in ("default", "S=16", "S=48"):
        secs, img, z, st, n = timed_frame(renders[name], msc.params, dev,
                                          seed)
        check_frame(img, z, OPT_RES, f"mesh {name}")
        check(n > 0, f"mesh {name}: visit-order launches {n}")
        runs[name].append((secs, st["visit_spill_max"], n))
    phase(29, f"{OPT_RES}x{OPT_RES} mesh stand-in frame s (visit spill "
              f"max, kernel 3 launches), in the order default, S=16, S=48: "
              f"{dict(runs)}")
    return dict(recs=recs, oks=oks, launches=runs["S=16"][0][2],
                frames={k: [r[0] for r in v] for k, v in runs.items()},
                launches_by_path={f"mesh_{OPT_RES}_super_{k}_1_frame":
                                  v[0][2] for k, v in runs.items()
                                  if k != "default"})


def compact_phase(msc, dev, seed) -> dict:
    """Phase 30: closest-hit ray compaction.  The mesh stand-in at 256x256
    in tiles of 16384 (two blocks of 8192 a closest-hit call), compaction
    on against off: image, z and stats bit-equal, the compacted sweep
    counted; frame seconds on, off and at the default tile, in turns."""
    from c_raytracer_tpu_torch.accel import traverse
    renders = {name: make_renderer(msc.static, cfg, OPT_RES, OPT_RES,
                                   device=dev, with_stats=True)
               for name, cfg in (
                   ("off", RenderConfig(tile_size=COMPACT_TILE)),
                   ("on", RenderConfig(tile_size=COMPACT_TILE,
                                       closest_compact="on")),
                   ("default tile", RenderConfig()))}
    runs = collections.defaultdict(list)
    frames = {}
    for name in ("off", "on", "default tile", "on", "off"):
        out = []
        sweeps = record(traverse, "_closest_scan_compact",
                        lambda: out.append(timed_frame(
                            renders[name], msc.params, dev, seed)),
                        lambda *a, **k: a[-1])
        secs, img, z, st, n = out[0]
        check((len(sweeps) > 0) == (name == "on")
              and all(b == COMPACT_BLOCK for b in sweeps),
              f"{name}: compacted sweeps {sweeps}")
        runs[name].append((secs, len(sweeps), n))
        frames.setdefault(name, (img, z, st))
    (i0, z0, s0), (i1, z1, s1) = frames["off"], frames["on"]
    check(torch.equal(i0, i1) and torch.equal(z0, z1) and s0 == s1,
          "compaction on vs off: image, z and stats bit-equal")
    phase(30, f"{OPT_RES}x{OPT_RES} mesh stand-in in tiles of "
              f"{COMPACT_TILE}: closest_compact on vs off bit-equal (image, "
              f"z, stats {s1}); frame s (compacted sweeps, kernel 3 "
              f"launches) in the order off, on, default tile, on, off: "
              f"{dict(runs)}")
    return dict(frames={k: [r[0] for r in v] for k, v in runs.items()},
                launches_by_path={
                    f"mesh_{OPT_RES}_tile_{COMPACT_TILE}_compact_1_frame":
                    runs["on"][0][2]})


def remat_names_phase(gsc, dev, seed) -> dict:
    """Phase 31: one forward+backward step of mean(img²) of the glass
    stand-in at 32x32 (phase 18's configuration) under each REMAT_NAMES
    tuple: seconds, peak memory, ratio to the forward, and grads against
    the ("occlusion",) step's, bit for bit under deterministic algorithms
    (or within 1e-6·max|g| with the ops that have no deterministic form
    named)."""
    import warnings

    glass_fns = {"philox_uniform": rng.philox_uniform,
                 "visit_order": pallas_visit.visit_order}
    res = REMAT_RES
    fwd = make_renderer(gsc.static, RenderConfig(max_bounces=REMAT_BOUNCES),
                        res, res, device=dev, with_stats=True)
    fwd_s = timed_frame(fwd, gsc.params, dev, seed)[0]
    out, ref, nondet = {}, None, set()
    was = torch.are_deterministic_algorithms_enabled()
    for names in REMAT_NAMES:
        render = make_renderer(gsc.static, RenderConfig(
            max_bounces=REMAT_BOUNCES, remat_names=names), res, res,
            device=dev, with_stats=True)
        torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                bsecs, _, blaunch, bpeak, named = time_fwd_bwd(
                    render, gsc.params, dev, seed, glass_fns, warmup=False)
        finally:
            torch.use_deterministic_algorithms(was)
        nondet |= {str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)}
        grads = {n: x.grad for n, x in named}
        out[names] = dict(s=bsecs, peak_mib=bpeak / 2**20,
                          ratio=bsecs / fwd_s, launches=blaunch)
        if ref is None:
            ref = grads
            continue
        for n, g in ref.items():
            check((g is None) == (grads[n] is None), f"{names} {n}: grad")
            if g is None:
                continue
            if nondet:
                scale = g.abs().max().item()
                check((grads[n] - g).abs().max().item() <= 1e-6 * scale,
                      f"{names} {n}: grads within 1e-6·max of the default")
            else:
                check(torch.equal(grads[n], g),
                      f"{names} {n}: grads bit-equal to the default")
        del grads, named
    phase(31, f"glass {res}x{res} (100 lights, {REMAT_BOUNCES} bounces) "
              f"fwd+bwd of mean(img²) by remat_names, under deterministic "
              f"algorithms: forward s {fwd_s:.6f}; "
              + "; ".join(f"{'+'.join(k)}: s {v['s']:.6f} ({v['ratio']:.3f}x "
                          f"the forward), peak {v['peak_mib']:.1f} MiB"
                          for k, v in out.items())
              + "; grads " + ("bit-equal to the default names'" if not nondet
                              else f"within 1e-6·max of the default names' "
                                   f"(no deterministic form: "
                                   f"{sorted(nondet)})"))
    return dict(forward_s=fwd_s, steps={"+".join(k): v
                                        for k, v in out.items()},
                nondeterministic_ops=sorted(nondet))


PR_RES = 64                # phase 32-33: exhaustive mesh frames by shards
# exhaustive sweeps, so that the frame cannot depend on how the triangles
# split: every closest-hit list (spill 0 at 256, phase 29), a capsule list
# that may hold every cluster, no shortlist (one of K per shard would hold
# more candidates than one of K over all), and 40 light samples (one chunk)
PR_CFG = RenderConfig(bvh_visits=256, bvh_shadow_visits=8556,
                      bvh_shadow_shortlist=0, sweep_dead_skip="on")
PR_LIGHTS = 40
PR_SHARDS = (2, 4)         # triangle ranges stacked in one process
PR_TIMED = (1, 2, 4)       # 256x256 mesh frames by range count, in turns
GLASS_TUNED = dict(bvh_visits=88, bvh_shadow_visits=400)  # --accel-tune's
STEP_RES = 64              # phase 33's train steps
PX_RES = 1024              # phase 33's px frame (the dense main path)
SP_RES = 64                # phase 33's sp frame
DENSE_STEP_TILE = 1024     # four tiles of the dense step: both px ranks work


def launch_counts():
    return {"philox_uniform": rng.philox_uniform,
            "fused_shadow_chunk": fused_shadow.fused_chunk,
            "visit_order": pallas_visit.visit_order}


def counted_frame(render, params, dev, seed):
    """One frame: (seconds, image, z, stats, launches), every launch count
    set to 0 just before it."""
    fns = launch_counts()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, z, st = render(params, rng.PhiloxSampler(seed, dev))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (secs, img, z, {k: float(v) for k, v in st.items()},
            {k: fn.launches for k, fn in fns.items()})


def same_frame(a, b, what: str, stats: bool = True) -> None:
    """Frames (image, z, stats) bit-equal."""
    check(torch.equal(a[0].cpu(), b[0].cpu()), f"{what}: image bit-equal")
    check(torch.equal(a[1].cpu(), b[1].cpu()), f"{what}: z bit-equal")
    if stats:
        check(a[2] == b[2], f"{what}: stats {a[2]} vs {b[2]}")


def shard_phase(msc, gsc, o1, d1, dev, gen, n_sm, seed) -> dict:
    """Phase 32: primitive-range shards stacked in one process.  Kernel 3
    at the per-shard shape (phase 7's first-round rays against each of
    the mesh stand-in's 4 ranges' clusters) bit-equal to plain and timed;
    exhaustive mesh frames (``PR_CFG``) at 2 and 4 ranges bit-equal to
    the unsharded frame; the glass stand-in at the budgets
    --accel-tune measured, 2 ranges against unsharded; the 256x256 mesh
    stand-in at the defaults by range count, in turns."""
    from c_raytracer_tpu_torch.accel import traverse
    from c_raytracer_tpu_torch.geometry import sharded
    cfg = RenderConfig()
    ds = device_scene(params_to_torch(msc.params, dev), msc.static)
    sh = sharded.shard_triangles(ds, msc.static, 4, tri_chunk=cfg.tri_chunk)
    sets = traverse.pack_clusters_sharded(sh, msc.static, cfg.bvh_cluster)
    V = cfg.resolved_visits(False)
    R = o1.shape[0]
    # the first-round rays, and rays aimed at each range's own boxes (the
    # first-round rays of the frame's middle tile enter two ranges only)
    oks = [compare_visit(o1, d1, cs.lo, cs.hi, V) for cs in sets]
    oks += [compare_visit(*aimed_rays(cs.lo, cs.hi, R, gen), cs.lo, cs.hi, V)
            for cs in sets]
    Ks = [cs.lo.shape[0] for cs in sets]
    # timed on the range that the first-round rays enter most (they enter
    # no cluster of the first two: a call with no work, whose profile kept
    # 7-9 of its 50 launches and failed the timing in one run)
    k = max(range(len(sets)), key=lambda i: oks[i][0])
    lo_k, hi_k = sets[k].lo, sets[k].hi
    live = int((torch.isfinite(o1).all(1) & torch.isfinite(d1).all(1)).sum())

    def run():
        return pallas_visit.visit_order(o1, d1, lo_k, hi_k, V)
    rec = time_line(
        f"visit order per shard (range {k} of 4) R={R} K={Ks[k]} V={V}",
        [device_ms(run, tries=5), device_ms(run, tries=5)],
        bound_ms(4 * (6 * R + 6 * Ks[k] + 2 * R * V + R),
                 VISIT_OPS_PER_BOX * live * Ks[k]),
        split=str(pallas_visit.visit_split(R, Ks[k], V, n_sm)))
    rec["plain_ms"] = device_ms(
        lambda: pallas_visit.visit_order_reference(o1, d1, lo_k, hi_k, V),
        10)
    rec.update(K=Ks[k], Ks=Ks, range=k, ok_and_spill=[o[:2] for o in oks],
               max_abs_err=max(o[2] for o in oks))
    phase(32, f"visit-order kernel bit-equal to plain per shard, 4 ranges "
              f"of the mesh stand-in (K = {Ks}), first-round rays R={R} "
              f"V={V}, then rays aimed at each range's boxes (ok slots, "
              f"spill max): {rec['ok_and_spill']}; range {k}: device "
              f"ms {rec['device_ms']:.6f} / bound {rec['bound_ms']:.6f} "
              f"({rec['bound_by']}) / plain {rec['plain_ms']:.6f}")

    def frame(sc, cfg, res, shards):
        return make_renderer(sc.static, cfg, res, res, device=dev,
                             with_stats=True, shards=shards)

    msc40 = dataclasses.replace(msc, static=cap_lights(msc, PR_LIGHTS))
    ref = counted_frame(frame(msc40, PR_CFG, PR_RES, None), msc.params, dev,
                        seed)[1:4]
    stacked = {}
    for S in PR_SHARDS:
        stacked[S] = counted_frame(frame(msc40, PR_CFG, PR_RES, S),
                                   msc.params, dev, seed)[1:4]
        same_frame(stacked[S], ref, f"{PR_RES}x{PR_RES} mesh, {S} ranges")
    check(ref[2]["visit_spill_max"] == 0, f"exhaustive: {ref[2]}")
    gcfg = RenderConfig(**GLASS_TUNED)
    g_ref = counted_frame(frame(gsc, gcfg, 32, None), gsc.params, dev,
                          seed)[1:4]
    g2 = counted_frame(frame(gsc, gcfg, 32, 2), gsc.params, dev, seed)[1:4]
    same_frame(g2, g_ref, "32x32 glass, 2 ranges", stats=False)
    check_frame(g2[0].cpu(), g2[1].cpu(), 32, "glass 2 ranges")
    phase(32, f"{PR_RES}x{PR_RES} mesh stand-in, {PR_LIGHTS} lights, "
              f"exhaustive sweeps: 2 and 4 "
              f"stacked ranges bit-equal to unsharded (image, z, stats "
              f"{ref[2]}); 32x32 glass at {GLASS_TUNED}, 2 ranges: image "
              f"and z bit-equal to unsharded (stats {g2[2]}; unsharded "
              f"{g_ref[2]})")
    del ref, g_ref, g2

    renders = {S: frame(msc, cfg, OPT_RES, S if S > 1 else None)
               for S in sorted(set(PR_TIMED))}
    runs = collections.defaultdict(list)
    for S in PR_TIMED:
        secs, img, z, st, n = counted_frame(renders[S], msc.params, dev,
                                            seed)
        check_frame(img, z, OPT_RES, f"mesh {S} ranges")
        check(n["visit_order"] > 0 and n["philox_uniform"] > 0,
              f"mesh {S} ranges: launches {n}")
        runs[S].append((secs, st["visit_spill_max"], n))
    phase(32, f"{OPT_RES}x{OPT_RES} mesh stand-in, RenderConfig(), by "
              f"stacked ranges (frame s, visit spill max, launches), in the "
              f"order {PR_TIMED}: {dict(runs)}")
    return dict(rec=rec, stacked=stacked, frames={
        S: [r[0] for r in v] for S, v in runs.items()},
        spill={S: v[0][1] for S, v in runs.items()},
        launches=runs[4][0][2])


def _rank_frame(out, name, render, params, device, seed):
    """A warm-up frame, then one timed frame with the launch and
    collective counts set to 0 just before it, into ``out[name]``."""
    from c_raytracer_tpu_torch.core import comm
    render(params, rng.PhiloxSampler(seed, device))
    comm.reset()
    secs, img, z, st, n = counted_frame(render, params, device, seed)
    out[name] = dict(img=img.cpu(), z=z.cpu(), stats=st, secs=secs,
                     launches=n, comm=dict(comm.COUNTS))


def _rank_step(out, name, static, params, cfg, mesh, device, seed):
    """One train step (mean((img − 0)²), SGD) into ``out[name]``."""
    from c_raytracer_tpu_torch.parallel import make_train_step
    from c_raytracer_tpu_torch.scene import named_leaves
    step = make_train_step(static, cfg, STEP_RES, STEP_RES, mesh,
                           device=device, with_grads=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss, grads = step(params, rng.PhiloxSampler(seed, device),
                          torch.zeros((STEP_RES, STEP_RES, 3)))
    torch.cuda.synchronize()
    out[name] = dict(loss=float(loss), secs=time.perf_counter() - t0,
                     grads={k: g.cpu() for k, g in named_leaves(grads)})


def _ranks_two(rank, device, seed):
    """Phase 33 on each of two gloo ranks sharing the card: px = 2 dense
    1024x1024, pr = 2 mesh (phase 32's exhaustive frame), sp = 2 dense
    64x64 path GI spp 4, and a train step each of the dense 64x64 (px = 2)
    and the exhaustive mesh 64x64 (pr = 2)."""
    from c_raytracer_tpu_torch.parallel import (make_mesh,
                                                make_sharded_renderer)
    sc = load_scene(SCENE)
    msc = reorder_scene(load_scene(MESH_SCENE))
    msc40 = dataclasses.replace(msc, static=cap_lights(msc, PR_LIGHTS))
    out = {}
    for name, s, cfg, res, mesh in (
            ("px", sc, RenderConfig(), PX_RES, make_mesh(2)),
            ("pr", msc40, PR_CFG, PR_RES, make_mesh(1, 1, 2)),
            ("sp", sc, GI_CFG, SP_RES, make_mesh(1, 2))):
        _rank_frame(out, name, make_sharded_renderer(
            s.static, cfg, res, res, mesh, device=device, with_stats=True),
            s.params, device, seed)
    _rank_step(out, "px_step", sc.static, sc.params,
               RenderConfig(tile_size=DENSE_STEP_TILE), make_mesh(2), device,
               seed)
    _rank_step(out, "pr_step", msc40.static, msc.params, PR_CFG,
               make_mesh(1, 1, 2), device, seed)
    return out


def _rank_nccl(rank, device, seed):
    """Phase 33's dense train step on an NCCL group of one rank."""
    from c_raytracer_tpu_torch.parallel import make_mesh
    out = {}
    sc = load_scene(SCENE)
    _rank_step(out, "px_step", sc.static, sc.params,
               RenderConfig(tile_size=DENSE_STEP_TILE), make_mesh(), device,
               seed)
    return out


def grads_close(got, want, what: str) -> dict:
    """Every leaf within 1e-6·max|g| of the one-process grad
    (``camera.focal_length`` at the scale of ``camera.position``).
    Returns the largest |difference| by leaf."""
    worst = {}
    for k, g in want.items():
        if not g.numel():
            continue
        scale = want[GRAD_SCALE_OF.get(k, k)].abs().max().item()
        err = (got[k] - g).abs().max().item()
        check(bool(torch.isfinite(got[k]).all()), f"{what} {k}: finite")
        check(err <= 1e-6 * scale, f"{what} {k}: {err} > 1e-6 x {scale}")
        worst[k] = err
    return worst


def ranks_phase(sc, msc, stacked, dev, seed) -> dict:
    """Phase 33: two gloo ranks on the card (parallel/launch.py) against
    one process, and the dense step on an NCCL group of one rank."""
    from c_raytracer_tpu_torch.parallel import launch, make_mesh
    from c_raytracer_tpu_torch.parallel import make_train_step
    from c_raytracer_tpu_torch.scene import named_leaves
    t0 = time.perf_counter()
    ranks = launch(_ranks_two, 2, backend="gloo", device="cuda",
                   args=(seed,))
    launch_s = time.perf_counter() - t0
    one_px = counted_frame(make_renderer(sc.static, RenderConfig(), PX_RES,
                                         PX_RES, device=dev, with_stats=True),
                           sc.params, dev, seed)[1:4]
    local = dataclasses.replace(GI_CFG, samples_per_pixel=2)
    reps = [make_renderer(sc.static, local, SP_RES, SP_RES, device=dev,
                          with_stats=True)(
        sc.params, rng.PhiloxSampler(seed, dev).fold_in(s)) for s in (0, 1)]
    one_sp = ((reps[0][0] + reps[1][0]) / 2, reps[0][1],
              {k: float(reps[0][2][k] + reps[1][2][k]) for k in reps[0][2]})
    for r in ranks:
        same_frame((r["px"]["img"], r["px"]["z"], r["px"]["stats"]), one_px,
                   f"px=2 dense {PX_RES}x{PX_RES} vs one process")
        same_frame((r["pr"]["img"], r["pr"]["z"], r["pr"]["stats"]),
                   stacked, f"pr=2 mesh {PR_RES}x{PR_RES} vs 2 stacked "
                   "ranges")
        same_frame((r["sp"]["img"], r["sp"]["z"], r["sp"]["stats"]), one_sp,
                   f"sp=2 dense {SP_RES}x{SP_RES} GI vs the replicas' mean")
        for name, kernels in (("px", ("philox_uniform", "fused_shadow_chunk")),
                              ("pr", ("philox_uniform", "visit_order"))):
            check(all(r[name]["launches"][k] > 0 for k in kernels),
                  f"{name} rank launches {r[name]['launches']}")
    steps = {}
    msc40 = dataclasses.replace(msc, static=cap_lights(msc, PR_LIGHTS))

    def one_process(s, cfg, shards=None):
        _, loss, grads = make_train_step(
            s.static, cfg, STEP_RES, STEP_RES, make_mesh(), device=dev,
            with_grads=True, shards=shards)(
            s.params, rng.PhiloxSampler(seed, dev),
            torch.zeros((STEP_RES, STEP_RES, 3)))
        return float(loss), {k: g.cpu() for k, g in named_leaves(grads)}

    # the pr ranks against one process with the same 2 ranges stacked
    # (the same graph: geometry/sharded.py); the unsharded step's grads
    # come from the sweep's own graph, which sums in another order, and
    # their largest difference is printed beside
    for name, s, cfg, shards in (
            ("px_step", sc, RenderConfig(tile_size=DENSE_STEP_TILE), None),
            ("pr_step", msc40, PR_CFG, 2)):
        loss, want = one_process(s, cfg, shards)
        check(want["tri_vertices" if name == "pr_step"
                   else "sphere_center"].abs().max().item() > 0,
              f"{name}: grads flow")
        steps[name] = {}
        for i, r in enumerate(ranks):
            check(r[name]["loss"] == loss,
                  f"{name} rank {i}: loss {r[name]['loss']} vs {loss}")
            steps[name][i] = grads_close(r[name]["grads"], want,
                                         f"{name} rank {i}")
        steps[name]["loss"] = loss
        steps[name]["secs"] = [r[name]["secs"] for r in ranks]
    u_loss, u_grads = one_process(msc40, PR_CFG)
    check(u_loss == steps["pr_step"]["loss"], "pr_step: unsharded loss")
    steps["pr_step"]["vs_unsharded"] = max(
        ((ranks[0]["pr_step"]["grads"][k] - g).abs().max().item()
         / max(u_grads[GRAD_SCALE_OF.get(k, k)].abs().max().item(), 1e-30))
        for k, g in u_grads.items() if g.numel())
    comm_ms = {name: [r[name]["comm"]["seconds"] * 1e3 for r in ranks]
               for name in ("px", "pr", "sp")}
    calls = {name: [r[name]["comm"]["calls"] for r in ranks]
             for name in ("px", "pr", "sp")}
    frame_s = {name: [r[name]["secs"] for r in ranks]
               for name in ("px", "pr", "sp")}
    phase(33, f"two gloo ranks on one card ({launch_s:.1f} s for the "
              f"launch): px=2 dense {PX_RES}x{PX_RES} and pr=2 mesh "
              f"{PR_RES}x{PR_RES} bit-equal to one process (image, z, "
              f"stats), sp=2 dense {SP_RES}x{SP_RES} path GI spp 4 equal "
              f"to the mean "
              f"of the two replicas; frame s by rank {frame_s}; host ms in "
              f"collectives a frame {comm_ms} over {calls} calls")
    for name in steps:
        phase(33, f"{name} {STEP_RES}x{STEP_RES} train step on two ranks: "
                  f"loss {steps[name]['loss']:.6e} equal to one process; "
                  f"step s {steps[name]['secs']}; largest |grad - one "
                  f"process| by leaf, rank 0: {steps[name][0]}"
                  + (f"; against the unsharded step, the largest |grad "
                     f"difference| / max|g| over the leaves "
                     f"{steps[name]['vs_unsharded']:.3e}"
                     if "vs_unsharded" in steps[name] else ""))
    nccl = launch(_rank_nccl, 1, backend="nccl", device="cuda",
                  args=(seed,))[0]["px_step"]
    check(nccl["loss"] == steps["px_step"]["loss"], "nccl world 1: loss")
    _, _, grads = make_train_step(
        sc.static, RenderConfig(tile_size=DENSE_STEP_TILE), STEP_RES,
        STEP_RES, make_mesh(), device=dev, with_grads=True)(
        sc.params, rng.PhiloxSampler(seed, dev),
        torch.zeros((STEP_RES, STEP_RES, 3)))
    nccl_err = grads_close(nccl["grads"], {k: g.cpu() for k, g in
                                           named_leaves(grads)}, "nccl")
    phase(33, f"the dense step on an NCCL group of one rank: loss equal, "
              f"step s {nccl['secs']:.6f}, largest |grad - one process| "
              f"{max(nccl_err.values()):.3e}")
    return dict(comm_ms=comm_ms, calls=calls, frame_s=frame_s,
                steps={k: {kk: vv for kk, vv in v.items()
                           if kk in ("loss", "secs", "vs_unsharded")}
                       for k, v in steps.items()},
                launch_s=launch_s)


def dryrun_phase() -> None:
    """Phase 34: the multichip dry run on two gloo ranks sharing the card."""
    from c_raytracer_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    out = dryrun_multichip(2, backend="gloo", device="cuda")
    phase(34, f"dryrun_multichip(2, gloo, cuda) passed both phases in "
              f"{time.perf_counter() - t0:.1f} s: losses "
              f"{[ph['loss'] for ph in out]}")


# phase 35: each chain's largest |kernel - plain| / |plain| (the FMA chain's
# plain version rounds each step once through float64, and a rare exact
# midpoint twice; sinf and powf are one library on both sides); the
# stream, the division chain and the gather's indices are bit-equal
ROOFLINE_RTOL = {"fma": 1e-6, "sin": 1e-6, "pow": 1e-6, "div": 0.0}
# phase 36: the flagship tool's arguments (res spp lights train_res
# chunks; 2 of its 6 steps, each ~15 s of host-bound launches at any
# train_res), and its forward card against CPU (res, spp, lights, chunks)
FLAGSHIP_STEPS = 2
FLAGSHIP_TOOL_ARGS = (8, 2, 4, 8, 2, "--steps", FLAGSHIP_STEPS)
FLAGSHIP_CPU = (8, 2, 4, 2)
SCALING_COUNTS = (1, 2)    # phase 37: gloo ranks sharing the card


def roofline_phase(dev, seed) -> dict:
    """Phase 35: the roofline probes (tools/roofline.py) at their full
    sizes: each kernel against its plain version on the probe's own
    starting array and on uniform inputs, then each probe timed."""
    from c_raytracer_tpu_torch.tools import roofline as rf
    gen = torch.Generator(device=dev).manual_seed(seed)
    for fn in (rf.stream, rf.chain, rf.gather):
        fn.launches = 0
    x = torch.rand(rf.STREAM_N, device=dev, generator=gen) * 8 - 4
    check(torch.equal(rf.stream(x), rf.stream_reference(x)),
          "stream kernel bit-equal to plain")
    del x
    errs = {}
    for op, k in (("fma", rf.FMA_K), ("sin", rf.SIN_K), ("pow", rf.POW_K),
                  ("div", rf.DIV_K)):
        lo, hi = {"fma": (0, 1), "sin": (0, 1), "pow": (0.1, 0.9),
                  "div": (0.5, 2.5)}[op]
        errs[op] = 0.0
        for x in (rf.chain_inputs(op, rf.CHAIN_N, dev),
                  lo + (hi - lo) * torch.rand(rf.CHAIN_N, device=dev,
                                              generator=gen)):
            got, want = rf.chain(x, op, k), rf.chain_reference(x, op, k)
            check(bool(torch.isfinite(got).all()), f"{op} chain finite")
            rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
            errs[op] = max(errs[op], rel.item())
        check(errs[op] <= ROOFLINE_RTOL[op],
              f"{op} chain: largest relative difference {errs[op]:.3e} > "
              f"{ROOFLINE_RTOL[op]}")
    tbl, idx = rf.gather_inputs(dev, seed=seed)
    out, sums = rf.gather(tbl, idx, with_sums=True)
    want_out, want_sums = rf.gather_reference(tbl, idx)
    check(torch.equal(out, want_out), "gather indices bit-equal to plain")
    errs["gather_sums"] = ((sums - want_sums).abs()
                           / want_sums.abs()).max().item()
    check(errs["gather_sums"] <= 1e-5, f"gather sums {errs['gather_sums']}")
    checked = {"stream": rf.stream.launches, "chain": rf.chain.launches,
               "gather": rf.gather.launches}
    phase(35, f"roofline kernels against their plain versions at full "
              f"size: stream and division bit-equal, largest relative "
              f"difference {errs}; launches {checked}")
    lines = [probe(dev) for probe in rf.PROBES]
    for line in lines:
        rate = [v for k, v in line.items() if k.startswith("achieved_")][0]
        check(rate > 0 and line["seconds"] > 0, f"{line['probe']}: {line}")
        phase(35, json.dumps(line))
    return dict(errs=errs, lines=lines)


def flagship_tool_phase(gsc, dev, seed, beside) -> dict:
    """Phase 36: the flagship tool (tools/flagship_s5.py) as a subprocess
    on the card, both JSON lines checked, and its forward phase card
    against CPU on the glass stand-in.  The check and ``beside()`` (work
    of another phase) run while the tool does, so the tool's seconds
    include that sharing of the card and the host; returns beside()'s
    result under ``beside``."""
    from c_raytracer_tpu_torch.tools import flagship_s5 as fs
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "c_raytracer_tpu_torch.tools.flagship_s5",
         *map(str, FLAGSHIP_TOOL_ARGS)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    res, spp, lights, chunks = FLAGSHIP_CPU
    sc = fs.cap_lights(gsc, lights)
    out = {}
    for d in (dev, torch.device("cpu")):
        img, z, st, secs = fs.forward(sc, fs.forward_config(spp), res, chunks,
                                      rng.PhiloxSampler(seed, d), device=d)
        out[d.type] = (torch.from_numpy(img), torch.from_numpy(z), st, secs)
    side = beside()
    stdout, stderr = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"flagship tool: exit {proc.returncode}\n"
                                f"{stdout}\n{stderr}")
    lines = [json.loads(s) for s in stdout.splitlines()
             if s.startswith("{")]
    check([ln.get("phase") for ln in lines] == ["forward", "train"],
          f"flagship tool lines {lines}")
    fwd, trn = lines
    check(all(math.isfinite(fwd[k]) for k in ("total_radiance",
                                              "mean_radiance")),
          f"flagship forward finite: {fwd}")
    check(fwd["total_radiance"] > 0 and fwd["total_rays"] > 0,
          f"flagship forward lit: {fwd}")
    check("shadow_spill_max" in fwd and "visit_spill_max" in fwd,
          f"flagship spill maxima: {fwd}")
    check(trn["loss_reduced"] is True
          and len(trn["losses"]) == FLAGSHIP_STEPS,
          f"flagship train: {trn}")
    phase(36, f"flagship tool {' '.join(map(str, FLAGSHIP_TOOL_ARGS))} on "
              f"the card in {wall:.1f} s (beside its CPU check, phase 37 "
              f"and phase 38's runs): {json.dumps(fwd)}; {json.dumps(trn)}")
    card, cpu = out["cuda"], out["cpu"]
    check(bool(torch.isfinite(card[0]).all()), "flagship forward finite")
    pix, zok = frames_agree(card[:3], cpu[:3], "flagship forward", share=0.99)
    phase(36, f"flagship forward {res}x{res} spp {spp} in {chunks} chunks, "
              f"{lights} lights: card vs CPU stats equal {card[2]}, image "
              f"{pix:.5f} / z {zok:.5f} of pixels within 1e-4·max, bit-equal "
              f"{torch.equal(card[0], cpu[0])}; s card {card[3]:.2f}, CPU "
              f"{cpu[3]:.2f}")
    return dict(tool=lines, wall=wall, agree=(pix, zok), beside=side)


def scaling_phase(dev) -> dict:
    """Phase 37: the scaling tool (tools/bench_scaling.py) at 1 and 2 gloo
    ranks sharing the card, each count's frame against one process's."""
    from c_raytracer_tpu_torch.tools import bench_scaling as bs
    results, frames = bs.run(SCALING_COUNTS, backend="gloo", device="cuda",
                             keep_frames=True)
    res = 256
    sc = load_scene(SCENE)
    one = make_renderer(sc.static, bs.scaling_config(res), res, res,
                        device=dev)(sc.params,
                                    rng.PhiloxSampler(bs.TIMED_SEED, dev))
    for n in SCALING_COUNTS:
        same_frame(frames[n], one,
                   f"scaling tool, {n} gloo ranks vs one process",
                   stats=False)
    check([r["shared_card"] for r in results] == [n > 1 for n in
                                                   SCALING_COUNTS],
          f"shared_card flags {results}")
    check(all(r["temp_bytes_per_device"] for r in results),
          f"peak memory read {results}")
    phase(37, f"bench_scaling {SCALING_COUNTS} gloo ranks on one card "
              f"(shared_card: no scaling across cards), each frame "
              f"bit-equal to one process's: {json.dumps(results)}")
    return dict(scaling=results)


# phase 38: the scene5 diagnostics (tools/s5_*.py) on the full glass
# stand-in, resolution and light count cut to fit; a number in their lines
# is a finite decimal (nan and inf do not match NUM)
S5_ARGS = {"s5_diag": (16,), "s5_union_stats": (32, 8),
           "s5_trunc_sweep": (16, 2), "s5_union_bench": (16, 8)}
NUM = r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?"


def s5_patterns(tool: str, args) -> list:
    """The lines of the JAX script ``tools/profiling/<tool>.py`` at
    ``args``, as regular expressions, in order."""
    from c_raytracer_tpu_torch.tools import (s5_diag, s5_trunc_sweep,
                                             s5_union_bench, s5_union_stats)
    N = NUM
    if tool == "s5_diag":
        P = args[0] ** 2
        return ([r"tris \d+ spheres \d+ planes \d+ emitters \(.+\) "
                 r"transp mats \(.+\)"]
                + [rf"closest v={v}: gid mismatches \d+/{P}, t err "
                   rf"\(matched\) {N}" for v in s5_diag.VISITS]
                + [rf"primary closest overlap: max \d+ mean {N}; spill>0 on "
                   rf"\d+/{P} rays \(V=16\)"]
                + [rf"shadow sv={sv} K={k}: blocked mismatch \d+/\d+, tint "
                   rf"err {N}" for sv, k in s5_diag.SHADOW_BUDGETS]
                + [rf"shadow spill \(V=16,K=32\) at hit pts: cluster spill "
                   rf"max \d+ mean {N}; tri spill max \d+ mean {N}"])
    if tool == "s5_union_stats":
        return ([r"tris \d+ emitter gid \d+ num_lights \d+",
                 rf"primary hits \d+ / {args[0] ** 2}"]
                + [rf"C=\s*{C} K=\s*\d+ \| per-seg overlap: mean\s+{N} "
                   rf"p50\s+{N} p95\s+{N} p99\s+{N} max\s+\d+ \| px-union: "
                   rf"mean\s+{N} p95\s+{N} p99\s+{N} max\s+\d+"
                   for C in s5_union_stats.CLUSTER_SIZES]
                + [rf"super G=\s*{G} Ks=\s*\d+ \| per-seg: mean\s+{N} "
                   rf"p99\s+{N} max\s+\d+ \| px-union: mean\s+{N} p99\s+{N} "
                   rf"max\s+\d+" for G in s5_union_stats.SUPER_GROUPS])
    if tool == "s5_trunc_sweep":
        return ([rf"brute: {N}s  max={N} mean={N}"]
                + [rf"v={v} sv={sv} K={k}:\s+{N}s  maxabs={N} rel={N} "
                   rf"rel\(bright\)={N}"
                   for v, sv, k in s5_trunc_sweep.BUDGETS])
    res, lights = args
    delta = rf"  max\|Δ\| vs first {N} \(rel {N}\)"
    return ([rf"{re.escape(os.path.basename(GLASS_SCENE))} {res}x{res}, "
             rf"lights capped {lights}, \d+ tris"]
            + [rf"{name}\s*:\s+{N} s/frame \(first {N}s\) total radiance "
               rf"{N}" + (delta if i else "")
               for i, name in enumerate(s5_union_bench.CONFIGS)])


def s5_segments(gsc, res: int, lc: int, d):
    """s5_union_stats' segments on device ``d`` and its C = 16 clusters:
    (lo, hi, hit points, light directions, light distances)."""
    from c_raytracer_tpu_torch.accel import traverse
    from c_raytracer_tpu_torch.tools import s5_union_stats
    params = params_to_torch(gsc.params, d)
    ds = device_scene(params, gsc.static)
    _, hp, ldir, ldist, _ = s5_union_stats.segments(
        ds, gsc.static, params.camera, res, lc, rng.PhiloxSampler(0, d))
    cs = traverse.pack_clusters(ds, gsc.static, 16)
    return cs.lo, cs.hi, hp, ldir, ldist


def s5_runs(gsc, dev) -> dict:
    """Phase 38's work, run while phase 36's flagship tool runs: the four
    scene5 diagnostics started as subprocesses on the card (all four at
    once), then s5_diag and s5_union_stats in this process on the card,
    their launches counted, and on the CPU."""
    from c_raytracer_tpu_torch.tools import s5_diag, s5_union_stats
    t0 = time.perf_counter()
    procs = {}
    for tool, args in S5_ARGS.items():
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs[tool] = (subprocess.Popen(
            [sys.executable, "-m", f"c_raytracer_tpu_torch.tools.{tool}",
             *map(str, args)], cwd=REPO, stdout=out, stderr=err, text=True),
            out, err)
    cpu = torch.device("cpu")
    runs = {"s5_diag": lambda d: s5_diag.run(gsc, *S5_ARGS["s5_diag"],
                                             device=d),
            "s5_union_stats": lambda d: s5_union_stats.run(
                gsc, *S5_ARGS["s5_union_stats"],
                sampler=rng.PhiloxSampler(0, d), device=d)}
    fns = launch_counts()
    here, launches = {}, {}
    for tool, run in runs.items():
        for fn in fns.values():
            fn.launches = 0
        card = run(dev)
        torch.cuda.synchronize()
        launches[tool + " (this process)"] = {k: fn.launches
                                              for k, fn in fns.items()}
        here[tool] = (card, run(cpu))
    return dict(t0=t0, procs=procs, here=here, launches=launches)


def s5_tools_phase(gsc, dev, runs: dict) -> dict:
    """Phase 38: the four scene5 diagnostics of ``s5_runs``: each
    subprocess's lines those of its JAX script, finite, and its kernels'
    launches; the in-process card lines equal to the subprocess's and
    their counts to the CPU's; s5_union_stats' slab test on the CPU's
    segments bit-equal on the card."""
    from c_raytracer_tpu_torch.tools import s5_union_stats
    here, launches = runs["here"], runs["launches"]
    cpu = torch.device("cpu")
    lines = {}
    for tool, (proc, out, err) in runs["procs"].items():
        rc = proc.wait(timeout=300)
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        check(rc == 0, f"{tool} {S5_ARGS[tool]}: exit {rc}\n{stdout}\n"
                       f"{stderr[-4000:]}")
        got = stdout.splitlines()
        want = s5_patterns(tool, S5_ARGS[tool])
        check(len(got) == len(want)
              and all(re.fullmatch(w, g) for g, w in zip(got, want)),
              f"{tool}: lines {got} against the JAX script's {want}")
        lines[tool] = got
        counts = [json.loads(s)["launches"] for s in stderr.splitlines()
                  if s.startswith('{"launches"')]
        check(len(counts) == 1 and counts[0]["visit_order"] > 0
              and (counts[0]["philox_uniform"] > 0) == (tool != "s5_diag"),
              f"{tool}: kernel launches {counts}")
        launches[tool] = counts[0]
    wall = time.perf_counter() - runs["t0"]

    # s5_diag: every count card against CPU
    (card, card_lines), (cpu_rec, _) = here["s5_diag"]
    check(card_lines == lines["s5_diag"],
          "s5_diag: the subprocess's lines are this process's")

    def counts(recs):
        return [{k: v for k, v in r.items() if isinstance(v, int)}
                for r in recs]

    check(counts(card) == counts(cpu_rec),
          f"s5_diag card vs CPU counts: {card} against {cpu_rec}")
    # s5_union_stats: every count card against CPU, though the light
    # points' sinf and cosf round differently on the card (phase 15); and
    # the slab test on the CPU's segments bit-equal on the card
    (card, card_lines), (cpu_rec, cpu_lines) = here["s5_union_stats"]
    check(card_lines == lines["s5_union_stats"],
          "s5_union_stats: the subprocess's lines are this process's")
    check(card_lines == cpu_lines and all(
        np.array_equal(a[k], b[k]) for a, b in zip(card, cpu_rec)
        for k in ("per_seg", "per_px")),
        f"s5_union_stats card vs CPU: {card_lines} against {cpu_lines}")
    res, lc = S5_ARGS["s5_union_stats"]
    lo, hi, hp, ldir, ldist = s5_segments(gsc, res, lc, cpu)
    _, _, c_hp, c_ldir, _ = s5_segments(gsc, res, lc, dev)
    on_card = s5_union_stats.union_stats(
        lo.to(dev), hi.to(dev), hp.to(dev), ldir.map(lambda a: a.to(dev)),
        ldist.to(dev))
    check(all(torch.equal(a.cpu(), b) for a, b in zip(
        on_card, s5_union_stats.union_stats(lo, hi, hp, ldir, ldist))),
          "s5_union_stats slab test on the same segments: card == CPU")
    d_hp = (c_hp.cpu() - hp).abs().max().item()
    d_dir = max((getattr(c_ldir, c).cpu() - getattr(ldir, c)).abs().max()
                .item() for c in "xyz")
    phase(38, f"s5_union_stats {res} {lc}: every overlap count card == "
              f"CPU, the hit points differing by up to {d_hp:.3e} and the "
              f"light directions by {d_dir:.3e}; the slab test on the "
              f"CPU's segments bit-equal on the card")
    phase(38, f"scene5 diagnostics {S5_ARGS} on the glass stand-in "
              f"({gsc.static.n_triangles} triangles) as subprocesses on the "
              f"card, collected {wall:.1f} s after they started (beside "
              f"phases 36-37), every JAX line there and finite; "
              f"s5_diag {S5_ARGS['s5_diag']} counts card == CPU; launches "
              f"{launches}")
    for tool in S5_ARGS:
        for line in lines[tool]:
            phase(38, f"{tool}: {line}")
    return dict(launches=launches, lines=lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # -- phase 1: the card ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
    phase(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"available={torch.cuda.is_available()}")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    _native.lib()
    phase(2, f"built {sorted(_native.build().values())} in "
             f"{time.perf_counter() - t0:.1f} s")

    # -- phase 3: Philox kernel against plain, bit-exact ------------------
    u = rng.philox_uniform((0, 0), (4,), device=dev).cpu()
    want = torch.tensor([(w >> 8) * 2.0 ** -24 for w in KAT["ctr0_key0"]])
    check(torch.equal(u, want), "philox known answer (ctr 0, key 0)")
    for key, shape in [((0xa4093822, 0x299f31d0), (2, 40, 65536)),
                       ((0xffffffff, 0xffffffff), (2, 16, 1000)),
                       (rng.path_key(args.seed, (0, 0, 0, 0)), (7,))]:
        k = rng.philox_uniform(key, shape, device=dev)
        p = rng.philox_uniform_reference(key, shape, device=dev)
        check(torch.equal(k, p), f"philox bit-exact {shape}")
        check(torch.equal(k.cpu(), rng.philox_uniform_reference(
            key, shape, device="cpu")), f"philox card == CPU {shape}")
    phase(3, "philox kernel bit-exact with plain: known answer, "
             "(2,40,65536) (2,16,1000) (7,)")

    # -- phase 4: fused kernel against plain ------------------------------
    sc = load_scene(SCENE)
    chunks = capture_round_chunks(sc.static, sc.params, dev)
    check(len(chunks) >= 2, f"{len(chunks)} rounds")
    u, px, scal_f, n_valid, kw0 = chunks[0]
    check(tuple(u.shape) == (2, 40, 65536) and n_valid >= 40,
          f"first-round chunk shape {tuple(u.shape)} n_valid {n_valid}")
    # the second round's chunk waits on the host, so that the frames' peak
    # memory holds only what it held before
    chunk2 = [x.cpu() if torch.is_tensor(x) else x for x in chunks[1]]
    del chunks
    fused_err = 0.0
    for phong, att in COMBOS:
        kw = dict(kw0, phong=phong, atten_kind=att)
        fused_err = max(fused_err, compare_fused(u, px, scal_f, n_valid, kw))
        # ragged: P = 1000, lc = 16, tail chunk n_valid = 12
        ur = rng.philox_uniform((5, 6), (2, 16, 1000), device=dev)
        compare_fused(ur, px[:, :1000].contiguous(), scal_f, 12,
                      dict(kw, lc=16))
    # gradients of the autograd.Function against the plain version's
    g = torch.rand(3, px.shape[1], device=dev)
    grads = []
    for fn in (fused_shadow.fused_chunk, fused_shadow.fused_chunk_reference):
        pxg = px.clone().requires_grad_(True)
        sfg = scal_f.clone().requires_grad_(True)
        (fn(u, pxg, sfg, n_valid, **kw0) * g).sum().backward()
        grads.append((pxg.grad, sfg.grad))
    for a, b in zip(*grads):
        check(bool(torch.isfinite(a).all()), "fused grad finite")
        d = (a - b).abs()
        frac = (d <= 1e-4 * b.abs() + 1e-6 * b.abs().max()).float().mean()
        check(frac.item() >= 0.9999, f"fused grad within tol ({frac:.6f})")
    phase(4, f"fused kernel matches plain at lc=40 P=65536 (first round of "
             f"the stand-in) and P=1000 tail, phong/blinn x none/lin/sqr; "
             f"max |diff| {fused_err:.3e}; grads of px, scal_f match")

    # -- phase 5: 64x64 frame on the card against the CPU -----------------
    cfg = RenderConfig()
    frames = {}
    for d in (dev, torch.device("cpu")):
        fn = make_renderer(sc.static, cfg, 64, 64, device=d, with_stats=True)
        img, z, st = fn(sc.params, rng.PhiloxSampler(args.seed, d))
        frames[d.type] = (img.cpu(), z.cpu(),
                          {k: float(v) for k, v in st.items()})
    (gi, gz, gs), (ci, cz, cs) = frames["cuda"], frames["cpu"]
    for k in ("main_rays", "shadow_rays"):
        check(abs(gs[k] - cs[k]) <= 1e-3 * cs[k], f"64x64 {k} {gs[k]} {cs[k]}")
    pix = ((gi - ci).abs().amax(-1) <= 1e-4 * ci.max()).float().mean().item()
    zok = ((gz - cz).abs() <= 1e-4 * cz.max()).float().mean().item()
    check(pix >= 0.999, f"64x64 image: {pix:.5f} of pixels within 1e-4·max")
    check(zok >= 0.999, f"64x64 z: {zok:.5f} of pixels within 1e-4·max")
    phase(5, f"64x64 card vs CPU: rays {gs['main_rays']:.0f}/"
             f"{gs['shadow_rays']:.0f} vs {cs['main_rays']:.0f}/"
             f"{cs['shadow_rays']:.0f}; image {pix:.5f}, z {zok:.5f} of "
             f"pixels within 1e-4·max")

    # -- phase 6: the main path at 1024x1024 ------------------------------
    render = make_renderer(sc.static, cfg, 1024, 1024, device=dev,
                           with_stats=True)
    img, z, st, secs, launches, peak = time_frames(
        render, sc.params, rng.PhiloxSampler(args.seed, dev), dev,
        {"philox_uniform": rng.philox_uniform,
         "fused_shadow_chunk": fused_shadow.fused_chunk})
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check_frame(img, z, 1024, "dense main path")
    rays = st["main_rays"] + st["shadow_rays"] + st["gi_rays"]
    frame_s = sum(secs) / len(secs)
    phase(6, f"1024x1024 stand-in, RenderConfig(): frame s "
             f"{[round(s, 6) for s in secs]} mean {frame_s:.6f}; "
             f"{rays / 2**20:.2f} rays/px; {rays / frame_s:.6e} rays/s; "
             f"peak {peak / 2**20:.1f} MiB; launches {launches}")

    key = rng.path_key(args.seed, (0, 0, 0, 0))
    shape = (2, 40, 65536)
    ph_plain, ph_issue = paired(
        lambda: rng.philox_uniform_reference(key, shape, device=dev),
        lambda: rng.philox_uniform(key, shape, device=dev), issue_ms)
    kw = dict(kw0, phong=True, atten_kind="sqr")
    fu_plain, fu_issue = paired(
        lambda: fused_shadow.fused_chunk_reference(u, px, scal_f, n_valid,
                                                   **kw),
        lambda: fused_shadow.fused_chunk(u, px, scal_f, n_valid, **kw),
        issue_ms)
    phase(6, f"chunk lc=40 P=65536 issue ms (CUDA events, 20 calls issued "
             f"one by one): philox kernel {mean(ph_issue):.4f} plain "
             f"{mean(ph_plain):.4f}; fused kernel {mean(fu_issue):.4f} "
             f"plain {mean(fu_plain):.4f}")

    # -- phase 7: visit-order kernel against plain, bit-equal -------------
    msc = reorder_scene(load_scene(MESH_SCENE))
    mparams = params_to_torch(msc.params, dev)
    ix = make_intersector(device_scene(mparams, msc.static), msc.static, cfg)
    lo, hi = ix.clusters.lo, ix.clusters.hi
    K = lo.shape[0]
    V = cfg.resolved_visits(False)
    check(K == 8556 and V == 16, f"stand-in clusters K={K} V={V}")
    o_all, d_all = primary_rays(mparams.camera, MESH_RES, MESH_RES)
    mid = (MESH_RES * MESH_RES // MESH_TILE) // 2     # a tile through the
    o1 = o_all[mid * MESH_TILE:(mid + 1) * MESH_TILE].contiguous()  # meshes
    d1 = d_all[mid * MESH_TILE:(mid + 1) * MESH_TILE].contiguous()
    n_ok, sp1, vo_err = compare_visit(o1, d1, lo, hi, V)
    calls, mesh_draws = record_mesh_calls(msc.static, msc.params, cfg, 64,
                                          32, dev, args.seed)  # one tile
    check(len(calls) >= 2 and calls[1][0].shape[0] == MESH_TILE,
          f"a reflection round: {len(calls)} visit calls")
    n_ok2, sp2, err2 = compare_visit(*calls[1])
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ro = (torch.rand((4096, 3), generator=gen, device=dev) * 8 - 4)
    rd = torch.randn((4096, 3), generator=gen, device=dev)
    rd = rd / rd.norm(dim=1, keepdim=True)
    cmd = torch.rand((4096,), generator=gen, device=dev) * 4
    n_ok3, sp3, err3 = compare_visit(ro, rd, lo, hi, 64, cmd)
    err4 = compare_visit(ro[:300].contiguous(), rd[:300].contiguous(), lo,
                         hi, V)[2]
    # ties across a slice and a cluster boundary of the call's own split:
    # boxes around each boundary that hold every origin (entry 0 for every
    # ray) and copies of the box most first-round rays enter first
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split = pallas_visit.visit_split(MESH_TILE, K, V, n_sm)
    check(split.cluster >= 2, f"a cluster boundary: {split}")
    pc, pe, _ = pallas_visit.visit_order_reference(o1, d1, lo, hi, V)
    first = int(torch.mode(pc[:, 0][pe[:, 0] < pallas_visit.FLT_MAX])[0])
    lo_t, hi_t = lo.clone(), hi.clone()
    for b in (split.slice, split.slice * split.warps):
        lo_t[b - 2:b + 2], hi_t[b - 2:b + 2] = -1e4, 1e4
        for i in (b - 3, b + 2):
            lo_t[i], hi_t[i] = lo[first], hi[first]
    n_ok5, sp5, err5 = compare_visit(o1, d1, lo_t, hi_t, V)
    ragged = []
    for k, v in ((K - 3, V), (1001, V), (5, 5), (5, 3)):
        lo_k, hi_k = lo[:k].contiguous(), hi[:k].contiguous()
        ragged.append(compare_visit(*aimed_rays(lo_k, hi_k, MESH_TILE, gen),
                                    lo_k, hi_k, v))
    vo_err = max(vo_err, err2, err3, err4, err5, *(r[2] for r in ragged))
    phase(7, f"visit-order kernel bit-equal to plain at K={K}: first round "
             f"R={MESH_TILE} V={V} ({n_ok} ok slots, spill max {sp1}); "
             f"reflection round ({n_ok2}, {sp2}); random rays V=64 with "
             f"count_max_dist ({n_ok3}, {sp3}); R=300; ties across slice "
             f"and cluster boundaries of {split} ({n_ok5}, {sp5}); K="
             f"{K - 3}, 1001, 5 (V=5, 3) "
             f"{[(r[0], r[1]) for r in ragged]}")

    # -- phase 8: 64x64 mesh frame on the card against the CPU ------------
    mframes = [render_on(d, msc.static, msc.params, cfg, 64, args.seed)
               for d in (dev, torch.device("cpu"))]
    pix, zok = frames_agree(*mframes, "64x64 mesh")
    gs = mframes[0][2]
    phase(8, f"64x64 mesh card vs CPU: rays {gs['main_rays']:.0f}/"
             f"{gs['shadow_rays']:.0f} equal, spill max shadow "
             f"{gs['shadow_spill_max']:.0f} visit {gs['visit_spill_max']:.0f}"
             f" equal; image {pix:.5f}, z {zok:.5f} of pixels within "
             f"1e-4·max")

    # -- phase 9: the mesh path at 512x512 --------------------------------
    mrender = make_renderer(msc.static, cfg, MESH_RES, MESH_RES, device=dev,
                            with_stats=True)
    img, z, mst, msecs, mlaunches, mpeak = time_frames(
        mrender, msc.params, rng.PhiloxSampler(args.seed, dev), dev,
        {"philox_uniform": rng.philox_uniform,
         "visit_order": pallas_visit.visit_order}, n=MESH_FRAMES)
    check(all(n > 0 for n in mlaunches.values()), f"launches {mlaunches}")
    check_frame(img, z, MESH_RES, "mesh main path")
    mrays = mst["main_rays"] + mst["shadow_rays"] + mst["gi_rays"]
    mframe_s = sum(msecs) / len(msecs)
    phase(9, f"{MESH_RES}x{MESH_RES} mesh stand-in, RenderConfig(): frame s "
             f"{[round(s, 6) for s in msecs]} mean {mframe_s:.6f}; "
             f"{mrays / MESH_RES**2:.2f} rays/px; {mrays / mframe_s:.6e} "
             f"rays/s; peak {mpeak / 2**20:.1f} MiB; launches {mlaunches}; "
             f"spill max shadow {mst['shadow_spill_max']:.0f} visit "
             f"{mst['visit_spill_max']:.0f}")
    vo_plain, vo_issue = paired(
        lambda: pallas_visit.visit_order_reference(o1, d1, lo, hi, V),
        lambda: pallas_visit.visit_order(o1, d1, lo, hi, V), issue_ms)
    phase(9, f"visit order R={MESH_TILE} K={K} V={V} issue ms (CUDA "
             f"events, 20 calls issued one by one): kernel "
             f"{mean(vo_issue):.4f} plain {mean(vo_plain):.4f}")

    # -- phase 10: device times against bounds ----------------------------
    per_frame = {name: {"dense": launches.get(name, 0) / 3,
                        "mesh": mlaunches.get(name, 0) / MESH_FRAMES}
                 for name in ("philox_uniform", "fused_shadow_chunk",
                              "visit_order")}
    phase(10, f"launches per frame {per_frame}")
    plain_dev = {
        "philox_uniform": device_ms(
            lambda: rng.philox_uniform_reference(key, shape, device=dev), 10),
        "fused_shadow_chunk": device_ms(
            lambda: fused_shadow.fused_chunk_reference(
                u, px, scal_f, n_valid, **kw0), 10),
        "visit_order": device_ms(
            lambda: pallas_visit.visit_order_reference(o1, d1, lo, hi, V),
            10)}
    phase(10, f"plain versions, device ms at the headline shapes "
              f"{plain_dev}")
    times = collections.defaultdict(list)
    # kernel 1, paired with torch.rand (library, kernel, kernel, library)
    mesh_draw = collections.Counter(mesh_draws).most_common(1)[0][0]
    for shp in (shape, mesh_draw):
        n = 1
        for s in shp:
            n *= s
        lib_runs, dev_runs = paired(
            lambda: torch.rand(shp, generator=gen, device=dev),
            lambda: rng.philox_uniform(key, shp, device=dev), device_ms)
        times["philox_uniform"].append(time_line(
            f"philox {shp}", dev_runs, bound_ms(4 * n, 0),
            library_ms=mean(lib_runs), library_runs=lib_runs,
            issue_ms=issue_ms(
                lambda: rng.philox_uniform(key, shp, device=dev))))
    # kernel 2: the first chunk of the first and of the second round
    chunk2 = [x.to(dev) if torch.is_tensor(x) else x for x in chunk2]
    op_weights = probe_op_weights(dev)
    phase(10, f"f32 operations of peak a sqrtf (data sheet), sinf, powf "
              f"and division (roofline chains): {op_weights}; data sheet "
              f"{DATASHEET_OP_WEIGHTS}")
    for what, (cu, cpx, csf, cnv, ckw) in (
            ("round 1", (u, px, scal_f, n_valid, kw0)), ("round 2", chunk2)):
        P = cpx.shape[1]
        live = int((cpx[16] > 0).sum())
        samples = live * min(ckw["lc"], cnv)
        fb = fused_bound(samples, P, live, csf.numel(), ckw["ns"],
                         ckw["npl"], op_weights)

        def run(cu=cu, cpx=cpx, csf=csf, cnv=cnv, ckw=ckw):
            return fused_shadow.fused_chunk(cu, cpx, csf, cnv, **ckw)

        dev_runs = [device_ms(run), device_ms(run)]
        times["fused_shadow_chunk"].append(time_line(
            f"fused chunk {what} lc={ckw['lc']} P={P} ({live} live pixels, "
            f"{samples} live samples)", dev_runs, fb["bound"],
            issue_ms=issue_ms(run), ops_count="probe-weighted",
            datasheet_bound_ms=fb["datasheet_bound_ms"],
            datasheet_share=fb["datasheet_bound_ms"] / mean(dev_runs)))
    # kernel 2's backward: _FusedChunk.backward (the plain version's
    # autograd at the same operands, on the card) on the round-1 chunk
    pxg = px.clone().requires_grad_(True)
    sfg = scal_f.clone().requires_grad_(True)
    out2 = fused_shadow.fused_chunk(u, pxg, sfg, n_valid, **kw0)
    g2 = torch.rand(out2.shape, generator=gen, device=dev)
    bwd_runs = [device_ms(lambda: torch.autograd.grad(
        out2, (pxg, sfg), g2, retain_graph=True), 20) for _ in range(2)]
    phase(10, f"fused chunk round 1 backward (plain version's autograd): "
              f"device ms {[round(x, 6) for x in bwd_runs]} mean "
              f"{mean(bwd_runs):.6f}; forward kernel "
              f"{times['fused_shadow_chunk'][0]['device_ms']:.6f}")
    del out2, pxg, sfg, g2
    # kernel 3: the mid tile's first round, the 64x32 frame's first and
    # reflection rounds
    for what, (co, cd, clo, chi, cv) in (
            ("first round, mid tile", (o1, d1, lo, hi, V)),
            ("first round, 64x32 frame", calls[0]),
            ("reflection round, 64x32 frame", calls[1])):
        R_, K_ = co.shape[0], clo.shape[0]
        live = int((torch.isfinite(co).all(1)
                    & torch.isfinite(cd).all(1)).sum())

        def run(co=co, cd=cd, clo=clo, chi=chi, cv=cv):
            return pallas_visit.visit_order(co, cd, clo, chi, cv)

        times["visit_order"].append(time_line(
            f"visit order {what} R={R_} K={K_} V={cv}",
            [device_ms(run), device_ms(run)],
            bound_ms(4 * (6 * R_ + 6 * K_ + 2 * R_ * cv + R_),
                     VISIT_OPS_PER_BOX * live * K_),
            issue_ms=issue_ms(run), split=str(pallas_visit.visit_split(
                R_, K_, cv, n_sm))))

    # -- phase 11: card grads against CPU grads ---------------------------
    gen_w = torch.Generator().manual_seed(args.seed)
    check(cfg.resolved_shadow_mode(False) == "shared"
          and cfg.resolved_shadow_shortlist(False) > 0,
          "the mesh frame takes the shared shortlist shadows")
    worst = {}
    for what, (gstatic, gparams, gx, gy) in {
            "dense 64x64": (sc.static, sc.params, 64, 64),
            "mesh 64x32": (msc.static, msc.params, 64, 32)}.items():
        w = torch.rand((gy, gx, 3), generator=gen_w)
        wz = torch.rand((gy, gx), generator=gen_w) * 0.01
        card = frame_grads(gstatic, gparams, cfg, gx, gy, dev, args.seed, w,
                           wz)
        cpu = frame_grads(gstatic, gparams, cfg, gx, gy, torch.device("cpu"),
                          args.seed, w, wz)
        worst[what] = grads_agree(card, cpu, what)
        del card, cpu
    phase(11, f"card vs CPU grads of sum(img·w) + sum(z·wz), every leaf "
              f"finite, max |diff| <= {GRAD_MAX_RTOL}·scale, >= 99.9% of "
              f"large leaves within {GRAD_RTOL}·scale; worst leaf (max "
              f"|diff| / scale) {worst}")

    # -- phase 12: dense forward+backward at 1024x1024 --------------------
    dense_fns = {"philox_uniform": rng.philox_uniform,
                 "fused_shadow_chunk": fused_shadow.fused_chunk}
    bsecs, bst, blaunch, bpeak, _ = time_fwd_bwd(render, sc.params, dev,
                                                 args.seed, dense_fns)
    brays = bst["main_rays"] + bst["shadow_rays"] + bst["gi_rays"]
    phase(12, f"1024x1024 stand-in, RenderConfig(), mean(img²) over every "
              f"leaf: fwd+bwd s {bsecs:.6f}; {brays / bsecs:.6e} rays/s "
              f"(the forward's rays); {bsecs / frame_s:.3f}x phase 6's "
              f"forward; peak {bpeak / 2**20:.1f} MiB; launches {blaunch}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    p_off, _ = grad_params(sc.params, dev)
    img, _ = make_renderer(sc.static, RenderConfig(remat=False), 1024, 1024,
                           device=dev)(p_off, rng.PhiloxSampler(args.seed,
                                                                dev))
    img.square().mean().backward()
    torch.cuda.synchronize()
    peak_off = torch.cuda.max_memory_allocated(dev)
    del p_off, img
    torch.cuda.empty_cache()
    phase(12, f"without rematerialisation (remat=False), one fwd+bwd step: "
              f"peak {peak_off / 2**20:.1f} MiB")
    # -- phase 13: mesh forward+backward at 256x256 -----------------------
    mesh_fns = {"philox_uniform": rng.philox_uniform,
                "visit_order": pallas_visit.visit_order}
    # no warm-up step (the budget of the whole run): phase 9's frames
    # warmed the path up; a quarter of its pixels, for the same reason
    srender = make_renderer(msc.static, cfg, MESH_STEP_RES, MESH_STEP_RES,
                            device=dev, with_stats=True)
    sfwd_s = timed_frame(srender, msc.params, dev, args.seed)[0]
    msecs_b, mst_b, mlaunch_b, mpeak_b, _ = time_fwd_bwd(
        srender, msc.params, dev, args.seed, mesh_fns, warmup=False)
    mrays_b = mst_b["main_rays"] + mst_b["shadow_rays"] + mst_b["gi_rays"]
    phase(13, f"{MESH_STEP_RES}x{MESH_STEP_RES} mesh stand-in, "
              f"RenderConfig(), mean(img²) over every leaf (no warm-up "
              f"step): fwd+bwd s {msecs_b:.6f}; "
              f"{mrays_b / msecs_b:.6e} rays/s (the forward's rays); "
              f"{msecs_b / sfwd_s:.3f}x its forward ({sfwd_s:.6f} s); peak "
              f"{mpeak_b / 2**20:.1f} MiB; launches {mlaunch_b}")
    del srender
    fwd_bwd_launches = {name: {"dense": blaunch.get(name, 0),
                               "mesh": mlaunch_b.get(name, 0)}
                        for name in per_frame}

    # -- phase 14: kernel 3 on the glass path, lists of 64, 128, 256 -------
    gsc = reorder_scene(load_scene(GLASS_SCENE))
    gcfg = RenderConfig()
    # (the closest-hit calls do not depend on the light samples' count)
    gcalls, _ = record_mesh_calls(with_lights(gsc, 20), gsc.params, gcfg,
                                  GLASS_RES, GLASS_RES, dev, args.seed)
    g_lo, g_hi = gcalls[0][2], gcalls[0][3]
    gK = g_lo.shape[0]
    check(gK == 6300 and gcalls[0][4] == 64 and all(
        c[0].shape[0] == MESH_TILE and c[4] == 64 for c in gcalls),
        f"glass stand-in: K={gK}, calls {[(c[0].shape[0], c[4]) for c in gcalls]}")
    # the first round's rays and the rays of the round that spills most
    # (deep inside the glass)
    spills = [int(pallas_visit.visit_order_reference(*c)[2].max())
              for c in gcalls]
    deep = gcalls[max(range(len(gcalls)), key=spills.__getitem__)]
    glass_rec = {}
    for v in GLASS_LISTS:
        if v == 64:
            n_launch = None       # the main path's count, phase 16
        else:
            # a frame at this budget (20 light samples: the closest-hit
            # calls do not depend on the count) for its launches a frame
            pallas_visit.visit_order.launches = 0
            make_renderer(with_lights(gsc, 20), RenderConfig(bvh_visits=v),
                          GLASS_LAUNCH_RES, GLASS_LAUNCH_RES, device=dev)(
                gsc.params, rng.PhiloxSampler(args.seed, dev))
            torch.cuda.synchronize()
            n_launch = pallas_visit.visit_order.launches
        errs, oks = [], []
        for co, cd in ((gcalls[0][0], gcalls[0][1]), (deep[0], deep[1])):
            n_ok, sp, err = compare_visit(co, cd, g_lo, g_hi, v)
            errs.append(err)
            oks.append((n_ok, sp))
        co, cd = gcalls[0][0], gcalls[0][1]
        live = int((torch.isfinite(co).all(1) & torch.isfinite(cd).all(1))
                   .sum())

        def run(co=co, cd=cd, v=v):
            return pallas_visit.visit_order(co, cd, g_lo, g_hi, v)
        rec = time_line(
            f"visit order glass first round R={MESH_TILE} K={gK} V={v}",
            [device_ms(run), device_ms(run)],
            bound_ms(4 * (6 * MESH_TILE + 6 * gK + 2 * MESH_TILE * v
                          + MESH_TILE), VISIT_OPS_PER_BOX * live * gK),
            split=str(pallas_visit.visit_split(MESH_TILE, gK, v, n_sm)))
        rec["deep_device_ms"] = device_ms(
            lambda v=v: pallas_visit.visit_order(deep[0], deep[1], g_lo,
                                                 g_hi, v))
        rec["plain_ms"] = device_ms(
            lambda v=v: pallas_visit.visit_order_reference(co, cd, g_lo,
                                                           g_hi, v), 10)
        rec.update(max_abs_err=max(errs), launches_per_frame=n_launch,
                   ok_and_spill=oks)
        glass_rec[v] = rec
    phase(14, f"visit-order kernel bit-equal to plain on the glass path, "
              f"R={MESH_TILE} K={gK}, first and deepest round (spill "
              f"{max(spills)}), V=64/128/256 (ok slots, spill max): "
              f"{ {v: r['ok_and_spill'] for v, r in glass_rec.items()} }; "
              f"deep round device ms "
              f"{ {v: round(r['deep_device_ms'], 6) for v, r in glass_rec.items()} }; "
              f"plain ms { {v: round(r['plain_ms'], 6) for v, r in glass_rec.items()} }; "
              f"launches a frame at bvh_visits=128/256 "
              f"{ {v: r['launches_per_frame'] for v, r in glass_rec.items()} }")

    # -- phase 15: transparent frames on the card against the CPU ----------
    agree = {}
    ex_sc = load_scene(EXAMPLE_SCENE)
    for what, (fstatic, fparams, fcfg, res) in {
            "glass 32x32 (2 bounces, 20 lights)": (
                with_lights(gsc, 20), gsc.params,
                RenderConfig(max_bounces=2), 32),
            "example.json 64x64 (3 bounces)": (
                ex_sc.static, ex_sc.params, RenderConfig(max_bounces=3),
                64)}.items():
        fr = [render_on(d, fstatic, fparams, fcfg, res, args.seed)
              for d in (dev, torch.device("cpu"))]
        for k in ("children_pushed", "dropped"):
            check(fr[0][2][k] == fr[1][2][k],
                  f"{what} {k}: card {fr[0][2][k]} cpu {fr[1][2][k]}")
        check_frame(fr[0][0], fr[0][1], res, what)
        # a refracted ray bends by the ulp differences of arcsin, arccos,
        # sin and cos between the card's and the CPU's libraries, and a
        # light sample grazing a silhouette then flips: 0.99 of pixels, as
        # the CPU tests hold the port against JAX on refraction frames
        agree[what] = frames_agree(*fr, what, share=0.99) + (fr[0][2],)
    phase(15, "card vs CPU, stats equal (rays, children, drops, spill "
              "maxima); (image, z) share of pixels within 1e-4·max, card "
              f"stats: {agree}")

    # -- phase 16: the glass stand-in at 64x64 -----------------------------
    grender = make_renderer(gsc.static, gcfg, GLASS_RES, GLASS_RES,
                            device=dev, with_stats=True)
    glass_fns = {"philox_uniform": rng.philox_uniform,
                 "visit_order": pallas_visit.visit_order}
    img, z, gst, gsecs, glaunches, gpeak = time_frames(
        grender, gsc.params, rng.PhiloxSampler(args.seed, dev), dev,
        glass_fns, n=GLASS_FRAMES)
    check(all(n > 0 for n in glaunches.values()), f"launches {glaunches}")
    check_frame(img, z, GLASS_RES, "glass main path")
    check(gst["children_pushed"] > 0 and gst["main_rays"] > GLASS_RES ** 2,
          f"glass stack rays {gst}")
    glass_rec[64]["launches_per_frame"] = (glaunches["visit_order"]
                                           / GLASS_FRAMES)
    grays = gst["main_rays"] + gst["shadow_rays"] + gst["gi_rays"]
    gframe_s = mean(gsecs)
    phase(16, f"{GLASS_RES}x{GLASS_RES} glass stand-in, RenderConfig(), 100 "
              f"lights: frame s {[round(x, 6) for x in gsecs]} mean "
              f"{gframe_s:.6f}; {grays / GLASS_RES ** 2:.2f} rays/px; "
              f"{grays / gframe_s:.6e} rays/s; peak {gpeak / 2**20:.1f} MiB; "
              f"launches {glaunches}; stats {gst}")

    # -- phase 17: scenes/example.json at 1024x1024 ------------------------
    erender = make_renderer(ex_sc.static, cfg, 1024, 1024, device=dev,
                            with_stats=True)
    img, z, est, esecs, elaunches, epeak = time_frames(
        erender, ex_sc.params, rng.PhiloxSampler(args.seed, dev), dev,
        {"philox_uniform": rng.philox_uniform})
    check(elaunches["philox_uniform"] > 0, f"launches {elaunches}")
    check_frame(img, z, 1024, "example.json 1024")
    erays = est["main_rays"] + est["shadow_rays"] + est["gi_rays"]
    phase(17, f"1024x1024 scenes/example.json, RenderConfig(): frame s "
              f"{[round(x, 6) for x in esecs]} mean {mean(esecs):.6f}; "
              f"{erays / 2**20:.2f} rays/px; {erays / mean(esecs):.6e} "
              f"rays/s; peak {epeak / 2**20:.1f} MiB; launches {elaunches}; "
              f"children {est['children_pushed']:.0f}")
    del erender

    # -- phase 18: glass forward+backward, and card vs CPU grads ----------
    gsecs_b, gst_b, glaunch_b, gpeak_b, _ = time_fwd_bwd(
        grender, gsc.params, dev, args.seed, glass_fns, warmup=False)
    grays_b = gst_b["main_rays"] + gst_b["shadow_rays"]
    phase(18, f"{GLASS_RES}x{GLASS_RES} glass stand-in, RenderConfig(), "
              f"mean(img²) over every leaf (no warm-up step): fwd+bwd s "
              f"{gsecs_b:.6f}; "
              f"{grays_b / gsecs_b:.6e} rays/s (the forward's rays); "
              f"{gsecs_b / gframe_s:.3f}x phase 16's forward; peak "
              f"{gpeak_b / 2**20:.1f} MiB; launches {glaunch_b}")
    w = torch.rand((16, 16, 3), generator=gen_w)
    wz = torch.rand((16, 16), generator=gen_w) * 0.01
    gstatic = with_lights(gsc, 20)
    gcfg16 = RenderConfig(max_bounces=2)
    card = frame_grads(gstatic, gsc.params, gcfg16, 16, 16, dev, args.seed,
                       w, wz)
    cpu = frame_grads(gstatic, gsc.params, gcfg16, 16, 16,
                      torch.device("cpu"), args.seed, w, wz)
    check(card["materials.kt"].abs().max() > 0
          and card["materials.refractive_index"].abs().max() > 0,
          "glass grads reach kt and the refractive index")
    worst_g = grads_agree(card, cpu, "glass 16x16")
    phase(18, f"card vs CPU grads, glass 16x16 (2 bounces, 20 lights), "
              f"every leaf finite and within tolerance; worst leaf "
              f"{worst_g}")

    gi = gi_phases(sc, gsc, dev, args.seed, gen, n_sm, op_weights)

    # -- phases 24-28: kernel 3 above 256, the CLIs, progressive renders,
    # the spill report and auto-tune, postprocessing ---------------------
    big = big_list_phase((o1, d1, lo, hi), (gcalls[0][0], gcalls[0][1],
                                            g_lo, g_hi),
                         glass_rec, gsc, dev, gen, n_sm, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cimg, cz, raw = engine_phase(sc, dev, tmp)
        progressive_phase(sc, dev, tmp)
        accel_phase(msc, gsc, (mframe_s, {"shadow": mst["shadow_spill_max"],
                                          "visit": mst["visit_spill_max"]}),
                    (gframe_s, {"shadow": gst["shadow_spill_max"],
                                "visit": gst["visit_spill_max"]}),
                    dev, tmp, n_sm)
        postprocess_phase(cimg, cz, raw, dev, tmp)
    del cimg, cz
    torch.cuda.empty_cache()

    # -- phases 29-31: the super visit order, compaction, remat names -----
    sup = super_phase(msc, o1, d1, dev, gen, n_sm, args.seed)
    comp = compact_phase(msc, dev, args.seed)
    remat_phase = remat_names_phase(gsc, dev, args.seed)

    # -- phases 32-34: primitive-range shards, ranks, the dry run ---------
    torch.cuda.empty_cache()
    shp = shard_phase(msc, gsc, o1, d1, dev, gen, n_sm, args.seed)
    rk = ranks_phase(sc, msc, shp["stacked"][2], dev, args.seed)
    dryrun_phase()

    # -- phases 35-37: the tools: roofline probes, flagship, scaling ------
    torch.cuda.empty_cache()
    roofline_phase(dev, args.seed)
    # phase 37 and phase 38's runs go beside phase 36's flagship tool, to
    # keep the run within its time
    fl = flagship_tool_phase(gsc, dev, args.seed, beside=lambda: (
        s5_runs(gsc, dev), scaling_phase(dev))[0])

    # -- phase 38: the scene5 diagnostics ---------------------------------
    s5 = s5_tools_phase(gsc, dev, fl["beside"])
    # each main path's launches, its counts set to 0 just before it ran
    by_path = {"dense_1024_3_frames": launches,
               f"mesh_512_{MESH_FRAMES}_frames": mlaunches,
               f"glass_64_{GLASS_FRAMES}_frames": glaunches,
               **gi["launches"],
               **{k: {"visit_order": n} for k, n in (
                   list(sup["launches_by_path"].items())
                   + list(comp["launches_by_path"].items()))},
               f"mesh_{OPT_RES}_4_ranges_1_frame": {
                   k: n for k, n in shp["launches"].items() if n},
               **{f"glass_{tool}_{'_'.join(map(str, S5_ARGS[tool]))}": {
                   k: n for k, n in s5["launches"][
                       tool + " (this process)"].items() if n}
                  for tool in ("s5_diag", "s5_union_stats")}}

    def path_launches(name):
        return {path: n[name] for path, n in by_path.items() if name in n}

    def row(name, source, replaces, err, issue, library):
        head = times[name][0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(path_launches(name).values()),
                "max_abs_err": max([err] + [r.get("max_abs_err", 0.0)
                                            for r in gi["kernel_gi"][name]]),
                "ms": head["device_ms"],
                "device_ms": head["device_ms"], "issue_ms": mean(issue),
                "plain_ms": plain_dev[name], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": library,
                "launches_per_frame": per_frame[name],
                "launches_fwd_bwd": fwd_bwd_launches[name],
                "launches_by_path": path_launches(name),
                "shapes": times[name], "gi_shapes": gi["kernel_gi"][name]}

    print(smi_line, flush=True)   # again, for readers of the output's tail
    print(json.dumps({"kernels": [
        row("philox_uniform", "c_raytracer_tpu_torch/csrc/philox.cu",
            "c_raytracer_tpu/core/rng.py:103", 0.0,
            ph_issue, times["philox_uniform"][0]["library_ms"]),
        dict(row("fused_shadow_chunk",
                 "c_raytracer_tpu_torch/csrc/fused_shadow.cu",
                 "c_raytracer_tpu/render/fused_shadow.py:195",
                 fused_err, fu_issue, None),
             backward_ms=mean(bwd_runs), backward_runs=bwd_runs,
             ops_count="probe-weighted", op_weights=op_weights),
        row("visit_order", "c_raytracer_tpu_torch/csrc/visit_order.cu",
            "c_raytracer_tpu/accel/pallas_visit.py:98", vo_err, vo_issue,
            None),
    ] + [{
        "name": f"visit_order[V={v}]", "route": "cuda",
        "source": "c_raytracer_tpu_torch/csrc/visit_order.cu",
        "replaces": "c_raytracer_tpu/accel/pallas_visit.py:98",
        "launches": (glaunches["visit_order"] if v == 64
                     else r["launches_per_frame"]),
        "max_abs_err": r["max_abs_err"], "ms": r["device_ms"],
        "device_ms": r["device_ms"], "deep_round_ms": r["deep_device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "launches_per_frame": r["launches_per_frame"], "split": r["split"],
        "path": (f"glass stand-in 64x64, RenderConfig(), {GLASS_FRAMES} "
                 f"frames" if v == 64
                 else f"glass {GLASS_LAUNCH_RES}x{GLASS_LAUNCH_RES} at "
                      f"bvh_visits={v}, one frame")}
        for v, r in glass_rec.items()] + [{
        "name": "visit_order[V=512]", "route": "cuda",
        "source": "c_raytracer_tpu_torch/csrc/visit_order.cu",
        "replaces": "c_raytracer_tpu/accel/pallas_visit.py:98",
        "launches": big["launches_per_frame"],
        "max_abs_err": big["max_abs_err"], "ms": big["device_ms"],
        "device_ms": big["device_ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None, "launches_per_frame": big["launches_per_frame"],
        "split": big["split"], "passes": 2,
        "mesh_device_ms": big["mesh_device_ms"], "by_v": big["by_v"],
        "path": f"glass {GLASS_LAUNCH_RES}x{GLASS_LAUNCH_RES} at "
                f"bvh_visits=512 (20 lights), one frame, two launches a "
                f"call"}] + [{
        "name": f"visit_order[super S={S}]", "route": "cuda",
        "source": "c_raytracer_tpu_torch/csrc/visit_order.cu",
        "replaces": "c_raytracer_tpu/accel/pallas_visit.py:98",
        "launches": sup["launches_by_path"][
            f"mesh_{OPT_RES}_super_S={S}_1_frame"],
        "max_abs_err": 0.0, "ms": r["device_ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "split": r["split"],
        "order_ms": r["order_ms"], "ok_and_spill": sup["oks"][S],
        "path": f"mesh stand-in {OPT_RES}x{OPT_RES} at bvh_super_group="
                f"{SUPER_G}, bvh_super_sel={S}, one frame (the super level: "
                f"K'=535 boxes)"}
        for S, r in sup["recs"].items()] + [{
        "name": f"visit_order[shard K={shp['rec']['K']}]", "route": "cuda",
        "source": "c_raytracer_tpu_torch/csrc/visit_order.cu",
        "replaces": "c_raytracer_tpu/accel/pallas_visit.py:98",
        "launches": shp["launches"]["visit_order"],
        "max_abs_err": shp["rec"]["max_abs_err"],
        "ms": shp["rec"]["device_ms"], "device_ms": shp["rec"]["device_ms"],
        "plain_ms": shp["rec"]["plain_ms"], "bound_ms": shp["rec"]["bound_ms"],
        "bound_by": shp["rec"]["bound_by"], "library_ms": None,
        "split": shp["rec"]["split"], "Ks": shp["rec"]["Ks"],
        "ok_and_spill": shp["rec"]["ok_and_spill"],
        "frames_by_ranges": shp["frames"], "spill_by_ranges": shp["spill"],
        "collectives_host_ms": rk["comm_ms"],
        "path": f"mesh stand-in {OPT_RES}x{OPT_RES} in 4 stacked triangle "
                f"ranges, one frame (kernel 3 once a range and call)"}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

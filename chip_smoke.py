"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels of c_raytracer_tpu_torch/csrc/ (nvcc, sm_90a,
into c_raytracer_tpu_torch/_build/), holds each kernel against its plain
PyTorch version on the card, renders a small frame on the card against the
same frame on the CPU, then drives the port's main path: the opaque
stand-in scene (scenes/spheres_opaque.json) at 1024x1024 under the default
RenderConfig, and times it.  Each phase prints one line; any failed check
raises, so the script exits non-zero and prints no result.  The last two
lines are the kernels' JSON summary and the run's result line.

It imports torch, numpy and the port only (never JAX).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from c_raytracer_tpu_torch import _native
from c_raytracer_tpu_torch.core import rng
from c_raytracer_tpu_torch.render import RenderConfig, fused_shadow
from c_raytracer_tpu_torch.render.api import make_renderer
from c_raytracer_tpu_torch.scene import load_scene

SCENE = "scenes/spheres_opaque.json"
KAT = {  # Random123 philox4x32_10, counter 0, key 0
    "ctr0_key0": (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)}
COMBOS = [(phong, att) for phong in (True, False)
          for att in ("none", "lin", "sqr")]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
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


def paired_ms(plain, kernel, reps: int = 20) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel,
                                                  plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def capture_first_round(static, params, device):
    """The fused-chunk operands of the first round of the stand-in scene
    at 256x256 (one tile of 65536 pixels: the main path's chunk shape)."""
    calls = []
    real = fused_shadow.fused_chunk

    def recording(u, px, scal_f, n_valid, **kw):
        calls.append((u.clone(), px.clone(), scal_f.clone(), n_valid, kw))
        return real(u, px, scal_f, n_valid, **kw)

    recording.launches = 0  # the launch counter lives on the module's name
    fused_shadow.fused_chunk = recording
    try:
        make_renderer(static, RenderConfig(max_bounces=0), 256, 256,
                      device=device)(params, rng.PhiloxSampler(11, device))
    finally:
        fused_shadow.fused_chunk = real
    return calls[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # -- phase 1: the card ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    phase(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
             f"available={torch.cuda.is_available()}")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    _native.lib()
    phase(2, f"built {_native.library_path()} in "
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
    u, px, scal_f, n_valid, kw0 = capture_first_round(sc.static, sc.params,
                                                      dev)
    check(tuple(u.shape) == (2, 40, 65536) and n_valid >= 40,
          f"first-round chunk shape {tuple(u.shape)} n_valid {n_valid}")
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
    sampler = rng.PhiloxSampler(args.seed, dev)
    render(sc.params, sampler)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rng.philox_uniform.launches = 0
    fused_shadow.fused_chunk.launches = 0
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, z, st = render(sc.params, sampler)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {"philox_uniform": rng.philox_uniform.launches,
                "fused_shadow_chunk": fused_shadow.fused_chunk.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    check(tuple(img.shape) == (1024, 1024, 3) and tuple(z.shape) == (
        1024, 1024), "main path shapes")
    check(bool(torch.isfinite(img).all()) and img.max().item() > 0,
          "main path image finite and lit")
    check(bool((z > 0).any()) and bool((z == 0).any()),
          "main path z has hits and misses")
    st = {k: float(v) for k, v in st.items()}
    rays = st["main_rays"] + st["shadow_rays"] + st["gi_rays"]
    frame_s = sum(secs) / len(secs)
    phase(6, f"1024x1024 stand-in, RenderConfig(): frame s "
             f"{[round(s, 6) for s in secs]} mean {frame_s:.6f}; "
             f"{rays / 2**20:.2f} rays/px; {rays / frame_s:.6e} rays/s; "
             f"peak {peak / 2**20:.1f} MiB; launches {launches}")

    key = rng.path_key(args.seed, (0, 0, 0, 0))
    shape = (2, 40, 65536)
    ph_ms, ph_plain = paired_ms(
        lambda: rng.philox_uniform_reference(key, shape, device=dev),
        lambda: rng.philox_uniform(key, shape, device=dev))
    kw = dict(kw0, phong=True, atten_kind="sqr")
    fu_ms, fu_plain = paired_ms(
        lambda: fused_shadow.fused_chunk_reference(u, px, scal_f, n_valid,
                                                   **kw),
        lambda: fused_shadow.fused_chunk(u, px, scal_f, n_valid, **kw))
    phase(6, f"chunk lc=40 P=65536 ms: philox kernel {ph_ms:.4f} plain "
             f"{ph_plain:.4f}; fused kernel {fu_ms:.4f} plain {fu_plain:.4f}")

    print(json.dumps({"kernels": [
        {"name": "philox_uniform", "route": "cuda",
         "source": "c_raytracer_tpu_torch/csrc/philox.cu",
         "replaces": "c_raytracer_tpu/core/rng.py:103",
         "launches": launches["philox_uniform"], "max_abs_err": 0.0,
         "ms": ph_ms, "plain_ms": ph_plain},
        {"name": "fused_shadow_chunk", "route": "cuda",
         "source": "c_raytracer_tpu_torch/csrc/fused_shadow.cu",
         "replaces": "c_raytracer_tpu/render/fused_shadow.py:195",
         "launches": launches["fused_shadow_chunk"],
         "max_abs_err": fused_err, "ms": fu_ms, "plain_ms": fu_plain},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

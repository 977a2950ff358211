"""Scaling benchmark: frame seconds and memory against the rank count of a
px mesh — the counterpart of ``tools/bench_scaling.py``, on ``parallel/``.

    python -m c_raytracer_tpu_torch.tools.bench_scaling [N ...]
        [--backend nccl|gloo] [--device cuda|cpu]

For each count N it starts N ranks (``parallel.launch``), builds
``make_sharded_renderer`` over ``make_mesh(n_px=N, n_sp=1)`` and renders
the dense stand-in ``scenes/spheres_opaque.json`` (an in-repo stand-in for
scene1, which is not in the repository) at 256² (``run``'s ``res``) under
``RenderConfig(max_bounces=4, rounds=5)``: one warm-up frame under Philox
seed 0, then one timed frame under seed 1 (the JAX tool's keys 0 and 1).
The px ranks take whole tiles, so the frame is cut into ``TILES`` tiles
of res²/8 pixels at every count (the default tile would be one tile at
256², which one rank renders while the others idle).

One JSON line a count, then ``{"scaling": [...]}`` with the JAX tool's
keys: ``devices``, ``seconds`` (the slowest rank's timed frame),
``speedup``, ``efficiency`` and ``mem_shrink``; where the JAX tool reads
XLA's compiled temp and argument sizes, ``temp_bytes_per_device`` is the
largest ``torch.cuda.max_memory_allocated`` of a rank over its timed frame
and ``argument_bytes_per_device`` the bytes of a rank's scene parameters
on its card, both ``null`` on CPU ranks (and ``mem_shrink`` with them).
``shared_card`` is true where two or more ranks share one card (gloo):
their seconds are no scaling across cards.

Backends: NCCL with one card a rank is the default on the card, with the
default counts 1, 2, 4 and 8 capped at the cards present; a count above
the cards raises (``launch``), as NCCL takes no two ranks on one card.
``--backend gloo`` lets the ranks share one card; ``--device cpu`` runs
CPU ranks under gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.parallel import (launch, make_mesh,
                                            make_sharded_renderer)
from c_raytracer_tpu_torch.render import RenderConfig
from c_raytracer_tpu_torch.scene import load_scene, named_leaves
from c_raytracer_tpu_torch.scene.convert import params_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCENE = os.path.join(ROOT, "scenes", "spheres_opaque.json")
COUNTS = (1, 2, 4, 8)
TILES = 8
WARM_SEED, TIMED_SEED = 0, 1


def scaling_config(res: int) -> RenderConfig:
    """The JAX tool's config, the frame cut into ``TILES`` tiles."""
    return RenderConfig(max_bounces=4, rounds=5,
                        tile_size=-(-res * res // TILES))


def _rank_frame(rank, device, res: int, keep_frame: bool):
    """One rank's warm-up and timed frame over a px mesh of every rank."""
    sc = load_scene(SCENE)
    mesh = make_mesh(n_px=torch.distributed.get_world_size(), n_sp=1)
    render = make_sharded_renderer(sc.static, scaling_config(res), res, res,
                                   mesh, device=device)
    params = params_to_torch(sc.params, device)
    card = device.type == "cuda"
    render(params, PhiloxSampler(WARM_SEED, device))
    if card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    img, z = render(params, PhiloxSampler(TIMED_SEED, device))
    if card:
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    return {"seconds": secs,
            "peak": torch.cuda.max_memory_allocated(device) if card else None,
            "params": sum(x.numel() * x.element_size()
                          for _, x in named_leaves(params)) if card else None,
            "frame": (img.cpu(), z.cpu()) if keep_frame and rank == 0
            else None}


def default_counts(device) -> list[int]:
    """1, 2, 4, 8 capped at the cards present (at least 1)."""
    cards = (torch.cuda.device_count()
             if device.type == "cuda" and torch.cuda.is_available() else 0)
    return [n for n in COUNTS if n <= max(cards, 1)]


def run(counts, *, res: int = 256, backend: str = "nccl", device="cuda",
        threads: int | None = None, keep_frames: bool = False, out=None):
    """One result a count (printed as a JSON line to ``out`` if given),
    then the ``scaling`` list; with ``keep_frames`` also rank 0's frame a
    count.  Returns (scaling list, {count: (image, z)})."""
    device = torch.device(device)
    results, frames = [], {}
    for n in counts:
        ranks = launch(_rank_frame, n, backend=backend, device=device,
                       args=(res, keep_frames), threads=threads)
        peaks = [r["peak"] for r in ranks]
        rec = {"devices": n, "seconds": max(r["seconds"] for r in ranks),
               "temp_bytes_per_device": None if None in peaks
               else max(peaks),
               "argument_bytes_per_device": ranks[0]["params"],
               "shared_card": device.type == "cuda" and backend == "gloo"
               and n > 1}
        results.append(rec)
        frames[n] = ranks[0]["frame"]
        if out is not None:
            print(json.dumps(rec), file=out, flush=True)
    base = results[0]["seconds"]
    base_mem = results[0]["temp_bytes_per_device"]
    for r in results:
        r["speedup"] = base / r["seconds"]
        r["efficiency"] = r["speedup"] / r["devices"]
        r["mem_shrink"] = (None if base_mem is None
                           else base_mem / max(r["temp_bytes_per_device"], 1))
    return results, frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("counts", type=int, nargs="*")
    ap.add_argument("--backend", default=None,
                    help="nccl (default on the card) or gloo (ranks share "
                         "one card; the only backend of CPU ranks)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    backend = args.backend or ("gloo" if device.type == "cpu" else "nccl")
    counts = args.counts or default_counts(device)
    results, _ = run(counts, backend=backend, device=device, out=sys.stdout)
    print(json.dumps({"scaling": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Entry points of the port, as in the repository's ``__graft_entry__.py``
for the JAX package.

* ``entry(device=)`` — a forward render step of the dense stand-in
  (``scenes/spheres_opaque.json``, 8 light samples, 4 bounces) at 64x64:
  returns ``(fn, example_args)``.
* ``dryrun_multichip(n, backend=, device=)`` — starts ``n`` ranks
  (parallel/launch.py) and runs ONE training step of each of two phases
  on a (px, sp, pr) mesh of them: the dense stand-in over (px, sp) with
  path GI (16x16, 2 light samples, 2 bounces, ``samples_per_pixel`` =
  2·n_sp), then the glass stand-in (``scenes/meshes_glass.json``: the
  dragon in glass, 100,000 triangles) over (px, pr) with the triangles
  split into pr ranges (16x16, 1 light sample, 3 bounces, path GI spp 2,
  ``tri_chunk=8192``).  The stand-ins take the places of the reference's
  scene1 and scene5, which the repository does not hold.

Pass criteria are on the gradients (every leaf finite, each ``must_flow``
field nonzero somewhere) and on the loss: finite, and above a floor set
from the frame's expected brightness (the target is black, so the loss is
mean(img²)).  The floors are a hundredth of the losses of one run on the
CPU (``python -m c_raytracer_tpu_torch.entry multichip 2 --device cpu``:
4.736e-06 dense, 6.917e-04 glass); an all-black frame fails.

The dry run takes the devices it is given and no others: under NCCL one
card a rank (fewer cards raise), gloo ranks share one card only when
asked (``backend="gloo"``), and CPU ranks only with ``device="cpu"``.

    python -m c_raytracer_tpu_torch.entry                  # entry() once
    python -m c_raytracer_tpu_torch.entry multichip N [--backend gloo]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os

import torch

from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.parallel import launch, make_mesh, make_train_step
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import load_scene
from c_raytracer_tpu_torch.scene.convert import named_leaves

_SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
DENSE_SCENE = os.path.join(_SCENES, "spheres_opaque.json")
GLASS_SCENE = os.path.join(_SCENES, "meshes_glass.json")
DENSE_LOSS_FLOOR = 4.7e-8   # a hundredth of the CPU run's losses above
GLASS_LOSS_FLOOR = 6.9e-6


def _load(path: str, num_lights=None):
    scene = load_scene(path)
    if num_lights is not None:
        nl = tuple(min(n, num_lights) for n in scene.static.num_lights)
        scene = dataclasses.replace(
            scene, static=dataclasses.replace(scene.static, num_lights=nl))
    return scene


def entry(device="cuda"):
    """(fn, example_args): a forward render step of the dense stand-in at
    64x64 on ``device``; ``fn(*example_args)`` returns (image, z)."""
    scene = _load(DENSE_SCENE, num_lights=8)
    cfg = RenderConfig(max_bounces=4, rounds=5)
    fn = make_renderer(scene.static, cfg, 64, 64, device=device)
    return fn, (scene.params, PhiloxSampler(0, device))


def _dense_phase(n: int):
    n_sp = 2 if n % 2 == 0 and n >= 2 else 1
    cfg = RenderConfig(max_bounces=2, rounds=3, gi_model="path",
                       samples_per_pixel=2 * n_sp, light_chunk=2)
    return dict(name="dense", mesh=(n // n_sp, n_sp, 1), scene=DENSE_SCENE,
                lights=2, reorder=False, cfg=cfg, lr=1e-3,
                floor=DENSE_LOSS_FLOOR,
                must_flow=("sphere_center", "sphere_radius", "materials",
                           "camera"))


def _glass_phase(n: int):
    n_pr = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if n_pr == 1:
        return None
    # enough bounces for light to pass through the glass dragon, and path
    # GI: path-traced GI × union shadows × sharded clusters × gradients
    cfg = RenderConfig(max_bounces=3, rounds=5, light_chunk=8,
                       tri_chunk=8192, gi_model="path", samples_per_pixel=2)
    return dict(name="glass", mesh=(n // n_pr, 1, n_pr), scene=GLASS_SCENE,
                lights=1, reorder=True, cfg=cfg, lr=1e-4,
                floor=GLASS_LOSS_FLOOR,
                must_flow=("tri_vertices", "materials"))


def _phases(n: int) -> list:
    return [p for p in (_dense_phase(n), _glass_phase(n)) if p is not None]


def _dryrun_rank(rank, device, n):
    """One rank of the dry run: one training step of each phase.  Returns
    per phase (loss, grads' finiteness, max|g| by top-level field,
    parameters' finiteness)."""
    out = []
    for ph in _phases(n):
        scene = _load(ph["scene"], num_lights=ph["lights"])
        if ph["reorder"]:
            scene = reorder_scene(scene)
        mesh = make_mesh(*ph["mesh"])
        res = 16
        step = make_train_step(scene.static, ph["cfg"], res, res, mesh,
                               device=device, learning_rate=ph["lr"],
                               with_grads=True)
        new, loss, grads = step(scene.params, PhiloxSampler(0, device),
                                torch.zeros((res, res, 3)))
        leaves = named_leaves(grads)
        gmax = {}
        for name, g in leaves:
            top = name.split(".")[0]
            gmax[top] = max(gmax.get(top, 0.0),
                            float(g.abs().max()) if g.numel() else 0.0)
        out.append(dict(
            loss=float(loss), mesh=ph["mesh"],
            grads_finite=all(bool(torch.isfinite(g).all()) for _, g in leaves),
            params_finite=all(bool(torch.isfinite(p).all())
                              for _, p in named_leaves(new)),
            gmax=gmax, n_triangles=scene.static.n_triangles))
    return out


def dryrun_multichip(n: int, *, backend: str = "nccl", device="cuda",
                     threads: int | None = None) -> list:
    """One sharded training step of each phase on ``n`` ranks; raises if a
    check fails.  Prints one report line a phase and returns the phases'
    results of rank 0."""
    ranks = launch(_dryrun_rank, n, backend=backend, device=device,
                   args=(n,), threads=threads)
    for i, ph in enumerate(_phases(n)):
        res = [r[i] for r in ranks]
        tag = f"dryrun {ph['name']}"
        losses = {r["loss"] for r in res}
        if len(losses) != 1:
            raise AssertionError(f"{tag}: the ranks' losses differ {losses}")
        loss = res[0]["loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"{tag}: non-finite loss {loss}")
        if not loss > ph["floor"]:
            raise AssertionError(f"{tag}: frame too dark, loss {loss:.3e} "
                                 f"<= {ph['floor']:.1e}")
        for r in res:
            if not r["grads_finite"]:
                raise AssertionError(f"{tag}: non-finite gradients")
            if not r["params_finite"]:
                raise AssertionError(f"{tag}: non-finite parameters")
            for field in ph["must_flow"]:
                if not r["gmax"][field] > 0.0:
                    raise AssertionError(f"{tag}: zero gradient for {field}")
        shape = dict(zip(("px", "sp", "pr"), ph["mesh"]))
        print(f"{tag}({n}, {backend}, {device}): mesh {shape}, "
              f"{res[0]['n_triangles']} triangles, loss={loss:.3e}, max|g| "
              + " ".join(f"{k}={res[0]['gmax'][k]:.2e}"
                         for k in ph["must_flow"]) + " OK", flush=True)
    return ranks[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", choices=("entry", "multichip"),
                    default="entry")
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help="default: gloo for --device cpu, else nccl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.what == "multichip":
        backend = args.backend or ("gloo" if args.device == "cpu"
                                   else "nccl")
        dryrun_multichip(args.n, backend=backend, device=args.device)
        return 0
    fn, example = entry(args.device)
    img, z = fn(*example)
    print("entry OK:", tuple(img.shape), tuple(z.shape), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""What the four scene5 diagnostics (``s5_union_bench``, ``s5_union_stats``,
``s5_trunc_sweep``, ``s5_diag``) share: their command line's ``--scene``
and ``--device``, the device check, the scene load, the clock and the kernels'
launch counts that ``main`` prints on stderr when it ends.

The JAX scripts load scene5 from a reference checkout that is not in the
repository; the port's tools default to the in-repo stand-in
``scenes/meshes_glass.json`` (the dragon in glass, 100 light samples, fov
55).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from c_raytracer_tpu_torch.accel import pallas_visit, reorder_scene
from c_raytracer_tpu_torch.core import rng
from c_raytracer_tpu_torch.render import fused_shadow
from c_raytracer_tpu_torch.scene import load_scene
from c_raytracer_tpu_torch.tools.flagship_s5 import DEFAULT_SCENE


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--scene`` and ``--device``; the caller
    adds the JAX script's positional arguments."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--scene", default=DEFAULT_SCENE)
    ap.add_argument("--device", default="cuda")
    return ap


def open_device(tool: str, name: str) -> torch.device:
    """The device to run on; a card that is not there is an error (there
    is no fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (pass --device cpu)")
    return device


def load(path: str):
    """The scene of ``path`` in Morton order, as the JAX scripts load it."""
    return reorder_scene(load_scene(path))


def clock(device) -> float:
    """``time.perf_counter()`` once the device has finished its work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def print_launches() -> None:
    """The port's kernels' launch counts in this process, one JSON line on
    stderr (all 0 on the CPU, where each wrapper runs its plain
    version)."""
    print(json.dumps({"launches": {
        "philox_uniform": rng.philox_uniform.launches,
        "fused_shadow_chunk": fused_shadow.fused_chunk.launches,
        "visit_order": pallas_visit.visit_order.launches}}),
        file=sys.stderr, flush=True)

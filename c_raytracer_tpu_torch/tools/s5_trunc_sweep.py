"""Cluster-sweep truncation error against the dense frame on the glass
stand-in, across visit and shortlist budgets: the counterpart of
``tools/profiling/s5_trunc_sweep.py``.

    python -m c_raytracer_tpu_torch.tools.s5_trunc_sweep [res] [nl]
        [--scene FILE] [--device cuda|cpu]

Defaults 32 4.  With every emitter capped at ``nl`` light samples,
``max_bounces=4``, ``rounds=6`` and ``tri_chunk=8192``, it renders the
brute-force frame (``accel="none"``) through ``make_renderer``, then the
cluster frame at (bvh_visits, bvh_shadow_visits, bvh_shadow_shortlist) =
(16, None, None), (16, 16, 32), (16, 64, 0), (16, 96, 0), (32, 128, 0),
each line giving the seconds (the renderer's build and its frame), the
largest absolute error, the largest relative error and the largest
relative error on the bright pixels (at least max(1e-5, 0.01 · max) in the
dense frame), in float radiance.

On a transparent scene ``shadow_mode="auto"`` resolves to ``union``: the
shadow budget is then the union sweep's and the shortlist is off.  The
records (and ``main``'s stderr) name the route each budget ran and the
frame's spill maxima.  The draws are ``PhiloxSampler(0)``'s, where the JAX
script has ``PRNGKey(0)``.  It runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.tools import s5_common
from c_raytracer_tpu_torch.tools.flagship_s5 import cap_lights

BASE = dict(max_bounces=4, rounds=6, tri_chunk=8192)
BUDGETS = ((16, None, None), (16, 16, 32), (16, 64, 0), (16, 96, 0),
           (32, 128, 0))


def configs():
    """The brute-force config, then the cluster config of each budget."""
    return [RenderConfig(accel="none", **BASE)] + [
        RenderConfig(accel="cluster", bvh_visits=v, bvh_shadow_visits=sv,
                     bvh_shadow_shortlist=k, **BASE)
        for v, sv, k in BUDGETS]


def _frame(static, params, cfg, res, sampler, device):
    """(image as numpy, stats, seconds of the build and the frame)."""
    t0 = s5_common.clock(device)
    fn = make_renderer(static, cfg, res, res, device=device, with_stats=True)
    img, _, st = fn(params, sampler)
    img = np.asarray(img.cpu())
    return img, st, s5_common.clock(device) - t0


def _record(cfg, any_transp, st, secs) -> dict:
    return {"accel": cfg.accel, "bvh_visits": cfg.bvh_visits,
            "bvh_shadow_visits": cfg.bvh_shadow_visits,
            "bvh_shadow_shortlist": cfg.bvh_shadow_shortlist,
            "shadow_mode": cfg.resolved_shadow_mode(any_transp),
            "seconds": secs,
            **{k: float(st[k]) for k in ("shadow_spill_max",
                                         "visit_spill_max")}}


def run(scene, res: int = 32, nl: int = 4, *, sampler=None, device,
        out=None):
    """The brute-force frame, then each budget's.  Returns (records,
    lines): a record a frame (its config's budgets, the shadow route it
    resolved, its spill maxima, seconds and, for the cluster frames, the
    errors) and the JAX script's lines, each also passed to ``out``."""
    sampler = sampler or PhiloxSampler(0, device)
    scene = cap_lights(scene, nl)
    static, params = scene.static, scene.params
    any_transp = any(static.is_transparent)
    lines, records = [], []

    def emit(line, rec):
        lines.append(line)
        records.append(rec)
        if out is not None:
            out(line)

    brute, *cluster = configs()
    img_b, st, secs = _frame(static, params, brute, res, sampler, device)
    emit(f"brute: {secs:.1f}s  max={img_b.max():.4e} "
         f"mean={img_b.mean():.4e}", _record(brute, any_transp, st, secs))
    for cfg in cluster:
        img_c, st, dt = _frame(static, params, cfg, res, sampler, device)
        ad = np.abs(img_c - img_b)
        denom = np.maximum(np.abs(img_b), 1e-6)
        rel = (ad / denom).max()
        # the dark pixels inflate the relative error meaninglessly
        bright = np.abs(img_b) >= max(1e-5, 0.01 * img_b.max())
        relb = (ad / denom)[bright].max() if bright.any() else 0.0
        emit(f"v={cfg.bvh_visits} sv={cfg.bvh_shadow_visits} "
             f"K={cfg.bvh_shadow_shortlist}: {dt:6.1f}s  "
             f"maxabs={ad.max():.3e} rel={rel:.3e} rel(bright)={relb:.3e}",
             dict(_record(cfg, any_transp, st, dt), maxabs=float(ad.max()),
                  rel=float(rel), rel_bright=float(relb)))
    return records, lines


def main(argv=None) -> int:
    ap = s5_common.parser(__doc__)
    ap.add_argument("res", type=int, nargs="?", default=32)
    ap.add_argument("nl", type=int, nargs="?", default=4)
    args = ap.parse_args(argv)
    device = s5_common.open_device("s5_trunc_sweep", args.device)
    records, _ = run(s5_common.load(args.scene), args.res, args.nl,
                     device=device, out=lambda line: print(line, flush=True))
    for rec in records:
        print(json.dumps(rec), file=sys.stderr)
    s5_common.print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())

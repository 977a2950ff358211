"""Shadow-segment overlap structure of the glass stand-in: the counterpart
of ``tools/profiling/s5_union_stats.py``.

    python -m c_raytracer_tpu_torch.tools.s5_union_stats [res] [lc]
        [--scene FILE] [--device cuda|cpu]

Defaults 64 40.  From the primary hits of a ``res``² frame
(``Intersector.closest`` under ``RenderConfig()``) it draws one chunk of
``lc`` real light samples on the first emitter (a sphere), at sampler path
``(7,)`` where the JAX script draws under ``fold_in(PRNGKey(0), 7)``, and
counts over the hit pixels:

* per segment, the clusters whose AABB the segment [0, ldist] overlaps
  (mean, p50, p95, p99, max);
* per pixel, the union of those clusters over the chunk's samples (mean,
  p95, p99, max);

at cluster sizes C = 16, 32, 64, 128 (``traverse.pack_clusters``), then at
super groups of G = 16 and 64 consecutive clusters of 16 (the last group
padded with lo = +inf, hi = -inf, which never forms a whole group).  Those
numbers size a one-kernel union visit step.

The slab test is the JAX script's ``seg_overlap_mask`` op for op: the
1e-30 guard, a division that divides (``scalar / tensor`` in torch would
multiply by a reciprocal), tmin and tmax seeded with -inf and +inf, the
entry clamped at 0 and ``entry < ldist``.  The masks stay (P, K),
componentwise, one sample step at a time: a (P, K, 3) intermediate at 64²
× 40 × 6,300 would be ~12 GB.  Percentiles are numpy's, on the host, as
in the JAX script.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from c_raytracer_tpu_torch.accel import make_intersector, traverse
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.rng import PhiloxSampler, SampleKey
from c_raytracer_tpu_torch.geometry import device_scene
from c_raytracer_tpu_torch.render import RenderConfig, shading
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.scene import params_to_torch
from c_raytracer_tpu_torch.tools import s5_common

CLUSTER_SIZES = (16, 32, 64, 128)
SUPER_GROUPS = (16, 64)
CHUNK_PATH = (7,)


@torch.no_grad()
def segments(ds, static, camera, res: int, lc: int, sampler):
    """The chunk's shadow segments: (hit (P,) bool, hit points (P, 3),
    light directions V3 (lc, P), light distances (lc, P)) and the header
    lines.  Non-hit lanes keep the JAX script's hit point o + d."""
    egid = int(static.emitter_prims[0])
    lines = [f"tris {static.n_triangles} emitter gid {egid} num_lights "
             f"{static.num_lights[egid]}"]
    o_a, d_a = primary_rays(camera, res, res)
    o, d = v3m.from_aos(o_a), v3m.from_aos(d_a)
    ic = make_intersector(ds, static, RenderConfig())
    t, gid, _, _ = ic.closest(o, d)
    hit = gid >= 0
    hp = o + d * torch.where(hit, t, 1.0)
    lines.append(f"primary hits {int(hit.sum())} / {res * res}")
    lp = shading._sphere_light_point(
        SampleKey(sampler, CHUNK_PATH), v3m.splat(ds.sph_center[egid]),
        ds.sph_radius[egid], hp, lc)
    lvec = lp - hp.map(lambda a: a[None])
    ldist = v3m.safe_mag(lvec)                        # (lc, P)
    ldir = lvec * (1.0 / torch.where(ldist == 0, 1.0, ldist))
    return hit, v3m.to_aos(hp), ldir, ldist, lines


def seg_overlap_mask(lo, hi, o2, d2, md):
    """(R, K) bool: segment [0, md] of ray (o2, d2) (R, 3) overlaps the
    AABB [lo, hi] (K, 3); componentwise, never (R, K, 3)."""
    dd = torch.where(torch.abs(d2) < 1e-30, 1e-30, d2)
    inv = torch.full_like(dd, 1.0) / dd
    shape = (o2.shape[0], lo.shape[0])
    tmin = torch.full(shape, -np.inf, device=o2.device)
    tmax = torch.full(shape, np.inf, device=o2.device)
    for c in range(3):
        t1 = (lo[None, :, c] - o2[:, None, c]) * inv[:, None, c]
        t2 = (hi[None, :, c] - o2[:, None, c]) * inv[:, None, c]
        tmin = torch.maximum(tmin, torch.minimum(t1, t2))
        tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    entry = torch.clamp(tmin, min=0.0)
    return (tmax >= entry) & (entry < md[:, None])


@torch.no_grad()
def union_stats(lo, hi, hp, ldir, ldist):
    """(per-segment overlap counts (lc, P), per-pixel union size (P,)),
    int32, one sample step at a time."""
    lc = ldist.shape[0]
    union = torch.zeros((hp.shape[0], lo.shape[0]), dtype=torch.bool,
                        device=hp.device)
    counts = []
    for i in range(lc):
        d_i = torch.stack([ldir.x[i], ldir.y[i], ldir.z[i]], -1)
        ov = seg_overlap_mask(lo, hi, hp, d_i, ldist[i])      # (P, K)
        union |= ov
        counts.append(ov.sum(-1, dtype=torch.int32))
    return torch.stack(counts), union.sum(-1, dtype=torch.int32)


def super_boxes(cs, group: int):
    """(lo, hi) of consecutive groups of ``group`` clusters of ``cs``."""
    K = cs.lo.shape[0]
    Ks = -(-K // group)
    pad = Ks * group - K
    lo = torch.cat([cs.lo, cs.lo.new_full((pad, 3), np.inf)])
    hi = torch.cat([cs.hi, cs.hi.new_full((pad, 3), -np.inf)])
    return (lo.reshape(Ks, group, 3).amin(1),
            hi.reshape(Ks, group, 3).amax(1))


def _host(stats, hit):
    per_seg, per_px = (x.cpu().numpy() for x in stats)
    hm = hit.cpu().numpy()
    return per_seg[:, hm].ravel(), per_px[hm]


def run(scene, res: int = 64, lc: int = 40, *, sampler=None, device,
        out=None):
    """The JAX script's statistics on ``scene``.  Returns (records,
    lines): a record a cluster size and super group (its hit lanes'
    per-segment counts and per-pixel union sizes), and the JAX script's
    lines, each also passed to ``out`` as it is made."""
    sampler = sampler or PhiloxSampler(0, device)
    params = params_to_torch(scene.params, device)
    ds = device_scene(params, scene.static)
    hit, hp, ldir, ldist, lines = segments(ds, scene.static, params.camera,
                                           res, lc, sampler)
    if out is not None:
        for line in lines:
            out(line)
    records = []

    def emit(line, rec):
        lines.append(line)
        records.append(rec)
        if out is not None:
            out(line)

    for C in CLUSTER_SIZES:
        cs = traverse.pack_clusters(ds, scene.static, C)
        K = cs.lo.shape[0]
        pseg, ppx = _host(union_stats(cs.lo, cs.hi, hp, ldir, ldist), hit)
        emit(f"C={C:4d} K={K:5d} | per-seg overlap: mean {pseg.mean():6.1f} "
             f"p50 {np.percentile(pseg, 50):5.0f} p95 "
             f"{np.percentile(pseg, 95):5.0f} p99 "
             f"{np.percentile(pseg, 99):5.0f} max {pseg.max():5d} | "
             f"px-union: mean {ppx.mean():6.1f} p95 "
             f"{np.percentile(ppx, 95):5.0f} p99 "
             f"{np.percentile(ppx, 99):5.0f} max {ppx.max():5d}",
             dict(level="clusters", size=C, K=K, per_seg=pseg, per_px=ppx))
    cs16 = traverse.pack_clusters(ds, scene.static, 16)
    for GRP in SUPER_GROUPS:
        slo, shi = super_boxes(cs16, GRP)
        Ks = slo.shape[0]
        pseg, ppx = _host(union_stats(slo, shi, hp, ldir, ldist), hit)
        emit(f"super G={GRP:3d} Ks={Ks:4d} | per-seg: mean {pseg.mean():5.1f} "
             f"p99 {np.percentile(pseg, 99):4.0f} max {pseg.max():4d} | "
             f"px-union: mean {ppx.mean():5.1f} p99 "
             f"{np.percentile(ppx, 99):4.0f} max {ppx.max():4d}",
             dict(level="super", size=GRP, K=Ks, per_seg=pseg, per_px=ppx))
    return records, lines


def main(argv=None) -> int:
    ap = s5_common.parser(__doc__)
    ap.add_argument("res", type=int, nargs="?", default=64)
    ap.add_argument("lc", type=int, nargs="?", default=40)
    args = ap.parse_args(argv)
    device = s5_common.open_device("s5_union_stats", args.device)
    run(s5_common.load(args.scene), args.res, args.lc, device=device,
        out=lambda line: print(line, flush=True))
    s5_common.print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())

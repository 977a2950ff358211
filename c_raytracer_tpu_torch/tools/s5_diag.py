"""Cluster-against-dense error of the glass stand-in by query type: the
counterpart of ``tools/profiling/s5_diag.py``.

    python -m c_raytracer_tpu_torch.tools.s5_diag [res]
        [--scene FILE] [--device cuda|cpu]

Default 32.  On the ``res``² primary rays:

* closest hits of the cluster intersector at ``bvh_visits`` = 16, 32, 64
  against the dense one (``accel="none"``, ``tri_chunk=8192``): gid
  mismatches and the largest t error of the matched hits;
* the primary rays' cluster overlap and spill at V = 16
  (``traverse.spill_counts``);
* at the dense hits, one shadow ray a pixel toward the centre of the
  first emitter's box (``exclude_gid`` = the emitter): blocked mismatches
  and the largest tint error over the hit pixels at six
  (bvh_shadow_visits, bvh_shadow_shortlist) budgets against the dense
  query; the port's ``any_counts`` + ``tint`` stand where the JAX
  package has ``any_tint`` (the shadow query takes no shortlist, so K
  only labels the line, as in the JAX script);
* the shared shadow sweep's cluster and triangle spill at V = 16, K = 32
  at the hit points (``traverse.shadow_spill_counts``).

Budgets above the cluster count are clamped to it (V = min(visits, K)), in
the sweeps and in every count, as in the JAX package.  It runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

import torch

from c_raytracer_tpu_torch.accel import make_intersector, traverse
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.geometry import device_scene
from c_raytracer_tpu_torch.render import RenderConfig
from c_raytracer_tpu_torch.render.camera import primary_rays
from c_raytracer_tpu_torch.scene import params_to_torch
from c_raytracer_tpu_torch.tools import s5_common

VISITS = (16, 32, 64)
SHADOW_BUDGETS = ((16, 32), (16, 0), (64, 0), (256, 0), (16, 256),
                  (64, 1024))
DENSE = RenderConfig(accel="none", tri_chunk=8192)


def _mean(x) -> float:
    """The mean in float32, as ``jnp.mean`` of an int32 array."""
    return float(x.to(torch.float32).mean())


def _any_tint(ix, o, d, max_dist, egid):
    """(blocked, tint V3): the JAX package's ``any_tint`` from the port's
    ``any_counts`` and ``tint`` (a tint of 1 in a scene without a
    transparent material)."""
    blocked, counts = ix.any_counts(o, d, max_dist, egid)
    if counts is None:
        one = torch.ones_like(max_dist)
        return blocked, v3m.V3(one, one, one)
    return blocked, ix.tint(counts)


@torch.no_grad()
def run(scene, res: int = 32, *, device, out=None):
    """The JAX script's diagnostics on ``scene``.  Returns (records,
    lines): a record a line (its counts and errors) and the JAX script's
    lines, each also passed to ``out`` as it is made."""
    static = scene.static
    params = params_to_torch(scene.params, device)
    ds = device_scene(params, static)
    P = res * res
    lines, records = [], []

    def emit(line, **rec):
        lines.append(line)
        records.append(rec)
        if out is not None:
            out(line)

    emit(f"tris {static.n_triangles} spheres {static.n_spheres} planes "
         f"{static.n_planes} emitters {static.emitter_prims} transp mats "
         f"{static.is_transparent}", query="scene",
         n_triangles=static.n_triangles)
    o_a, d_a = primary_rays(params.camera, res, res)
    o, d = v3m.from_aos(o_a), v3m.from_aos(d_a)

    ib = make_intersector(ds, static, DENSE)
    tb, gb, _, _ = ib.closest(o, d)
    for v in VISITS:
        ic = make_intersector(ds, static, RenderConfig(accel="cluster",
                                                       bvh_visits=v))
        tc, gc, _, _ = ic.closest(o, d)
        neq = int((gb != gc).sum())
        terr = float(torch.where((gb == gc) & (gb >= 0), tb - tc,
                                 0.0).abs().max())
        emit(f"closest v={v}: gid mismatches {neq}/{P}, "
             f"t err (matched) {terr:.2e}", query="closest", visits=v,
             gid_mismatches=neq, t_err=terr)

    cs = make_intersector(ds, static, RenderConfig(accel="cluster")).clusters
    n_ov, spill = traverse.spill_counts(cs, o_a, d_a, 16)
    n_spill = int((spill > 0).sum())
    emit(f"primary closest overlap: max {int(n_ov.max())} "
         f"mean {_mean(n_ov):.1f}; spill>0 on {n_spill}/{P} rays (V=16)",
         query="closest_spill", overlap_max=int(n_ov.max()),
         overlap_mean=_mean(n_ov), spill_rays=n_spill)

    hit = gb >= 0
    n_hit = int(hit.sum())
    hp = o + d * torch.where(hit, tb, 1.0)
    egid = int(static.emitter_prims[0])
    elo, ehi = make_intersector(ds, static, RenderConfig(
        accel="cluster")).emitter_bounds(egid)
    # one deterministic sample a pixel: toward the emitter's box centre
    ecenter = 0.5 * (elo + ehi)
    lvec = v3m.splat(ecenter) - hp
    ldist = v3m.safe_mag(lvec)
    ldir = lvec * (1.0 / torch.where(ldist == 0, 1.0, ldist))
    bb, tnb = _any_tint(ib, hp, ldir, ldist, egid)
    for sv, k in SHADOW_BUDGETS:
        icc = make_intersector(ds, static, RenderConfig(
            accel="cluster", bvh_shadow_visits=sv, bvh_shadow_shortlist=k))
        bc, tnc = _any_tint(icc, hp, ldir, ldist, egid)
        bneq = int(((bb != bc) & hit).sum())
        terr = max(float(torch.where(hit, getattr(tnb, c) - getattr(tnc, c),
                                     0.0).abs().max()) for c in "xyz")
        emit(f"shadow sv={sv} K={k}: blocked mismatch {bneq}/{n_hit}"
             f", tint err {terr:.3e}", query="shadow", shadow_visits=sv,
             shortlist=k, blocked_mismatches=bneq, hits=n_hit, tint_err=terr)

    cl_sp, tri_sp = traverse.shadow_spill_counts(
        cs, v3m.to_aos(hp), elo, ehi, 16, 32)
    cl_sp, tri_sp = cl_sp[hit], tri_sp[hit]
    emit(f"shadow spill (V=16,K=32) at hit pts: cluster spill max "
         f"{int(cl_sp.max())} mean {_mean(cl_sp):.1f}; "
         f"tri spill max {int(tri_sp.max())} mean "
         f"{_mean(tri_sp):.1f}", query="shadow_spill",
         cluster_spill_max=int(cl_sp.max()), cluster_spill_mean=_mean(cl_sp),
         tri_spill_max=int(tri_sp.max()), tri_spill_mean=_mean(tri_sp))
    return records, lines


def main(argv=None) -> int:
    ap = s5_common.parser(__doc__)
    ap.add_argument("res", type=int, nargs="?", default=32)
    args = ap.parse_args(argv)
    device = s5_common.open_device("s5_diag", args.device)
    run(s5_common.load(args.scene), args.res, device=device,
        out=lambda line: print(line, flush=True))
    s5_common.print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())

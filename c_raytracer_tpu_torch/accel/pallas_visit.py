"""Cluster visit order (kernel 3), as in
``c_raytracer_tpu.accel.pallas_visit``.

For every ray, the slab test against every cluster AABB and the V nearest
overlapped clusters in ascending entry distance, ties to the lowest cluster
id, with the per-ray spill count (overlaps beyond V) — the body of
``c_raytracer_tpu/accel/traverse.py`` ``_visit_order``.

* ``visit_order`` — on a CUDA tensor it launches ``csrc/visit_order.cu``,
  which replaces the Pallas kernel ``visit_order_fused`` / ``_kernel``;
  on a CPU tensor it runs the plain version.
* ``visit_order_reference`` — the plain PyTorch version, the XLA body in
  torch; it orders with a stable sort, so ties keep the lowest id.
* ``visit_split`` — how the kernel divides a call: clusters of blocks
  that hold 32 rays each, every warp scanning one id-contiguous slice of
  the boxes (the kernel merges the warps' lists by (key, id), which the
  CPU tests model in numpy).  The kernel's ring and shared-memory layout
  are its own compile-time constants; only the split is chosen here.
  Lists of up to 64 live in registers, of 128 and 256 in shared memory.
* ``visit_passes`` — a V above 256, the largest compiled list, runs in
  passes of up to 256 slots, one launch each: every pass after the first
  admits only boxes after the previous pass's last slot in (key, id)
  order, so the passes concatenate to the first V of the stable sort.
  The card takes any V up to K, as the plain version does.

The JAX package keeps its kernel behind ``RenderConfig.pallas_visit``
(default "off"), a decision about its TPU toolchain, and its kernel route
reports spill 0.  Here the kernel is the visit order on the card whatever
``pallas_visit`` says: both routes give the same lists, and the kernel
counts the exact spill of the plain version, ``count_max_dist`` included,
so the always-on truncation guard stays on.

Shapes: o, d (R, 3) and lo, hi (K, 3) float32; count_max_dist (R,) or
None.  Returns cids (R, V) int32, entry (R, V) float32 (FLT_MAX in empty
slots; ``ok = entry < FLT_MAX``) and spill (R,) int32.  Empty slots may
hold any cid in [0, K).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from c_raytracer_tpu_torch import _native
from c_raytracer_tpu_torch.core import tracing

FLT_MAX = float(np.finfo(np.float32).max)
LIST_SIZES = (8, 16, 32, 64, 128, 256)  # the kernel's compiled list sizes
PASS_V = LIST_SIZES[-1]       # a launch's slots; a larger V runs in passes

LANES = 32                    # rays per block: one per lane
MAX_CLUSTER = 8               # the portable thread-block cluster size
N_SM_H100 = 132


@dataclasses.dataclass(frozen=True)
class VisitSplit:
    """How kernel 3 divides one call: ``groups`` clusters of ``cluster``
    blocks hold 32 rays each; each of a cluster's ``warps * cluster``
    warps scans ``slice`` boxes, slice ``s`` covering ids
    [s·slice, (s+1)·slice) ∩ [0, K), and keeps its own sorted ``vm``-list."""

    vm: int
    warps: int
    cluster: int
    groups: int
    slice: int
    passes: int = 1

    def slices(self, K: int) -> list[tuple[int, int]]:
        """(start, end) of each warp's slice, in slice order: block rank
        ``s // warps``, warp ``s % warps``; trailing slices may be empty."""
        n = self.warps * self.cluster
        return [(min(s * self.slice, K), min((s + 1) * self.slice, K))
                for s in range(n)]


def warps_of(vm: int) -> int:
    """Warps a block of list size ``vm``: 8 up to 32; 4 at 64, whose
    register lists take twice the registers, and at 128; 2 at 256, whose
    shared-memory lists take 64 KB a warp."""
    return 8 if vm <= 32 else (4 if vm <= 128 else 2)


def visit_passes(V: int) -> list[tuple[int, int]]:
    """(first slot, slots) of each launch of a V-slot call: one pass up
    to ``PASS_V``, above it passes of ``PASS_V`` and the rest."""
    return [(c, min(PASS_V, V - c)) for c in range(0, V, PASS_V)]


def visit_split(R: int, K: int, V: int, n_sm: int = N_SM_H100) -> VisitSplit:
    """The split of an (R rays, K boxes, V visits) call on a card of
    ``n_sm`` SMs: ``warps_of(VM)`` warps a block and the smallest cluster
    in 1, 2, 4, 8 that puts a block on each SM (R = 2048: 64 ray groups ×
    4); slices are multiples of 4 boxes, so every slice and ring tile
    starts 16-byte aligned.  VM is the smallest compiled list that holds
    V; a V above 256 runs in ``passes`` (``visit_passes``), and this is
    the split of its first, a full list of 256 (a shorter last pass takes
    the split of its own V).  Any V in 1..K is taken."""
    if not 1 <= V <= K:
        raise ValueError(f"visit_order: V={V} outside 1..K={K}")
    vm = next(v for v in LIST_SIZES if v >= min(V, PASS_V))
    groups = -(-R // LANES)
    warps = warps_of(vm)
    cluster = next((c for c in (1, 2, 4) if groups * c >= n_sm), MAX_CLUSTER)
    per = -(-K // (warps * cluster))
    return VisitSplit(vm=vm, warps=warps, cluster=cluster, groups=groups,
                      slice=-(-per // 4) * 4, passes=len(visit_passes(V)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def visit_order_reference(o, d, lo, hi, V: int, count_max_dist=None):
    """Plain PyTorch version of kernel 3, bit-exact with it."""
    dd = torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    inv = 1.0 / dd
    tmin = tmax = None
    # one axis at a time: (R, K) temporaries; max/min are exact in any order
    for c in range(3):
        t1 = (lo[None, :, c] - o[:, c, None]) * inv[:, c, None]
        t2 = (hi[None, :, c] - o[:, c, None]) * inv[:, c, None]
        lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo_t if tmin is None else torch.maximum(tmin, lo_t)
        tmax = hi_t if tmax is None else torch.minimum(tmax, hi_t)
    entry = torch.clamp(tmin, min=0.0)
    overlap = tmax >= entry
    counted = (overlap if count_max_dist is None
               else overlap & (entry < count_max_dist[:, None]))
    spill = torch.clamp(counted.sum(-1) - V, min=0).to(torch.int32)
    key = torch.where(overlap, entry, FLT_MAX)
    vals, idx = torch.sort(key, dim=1, stable=True)
    return idx[:, :V].to(torch.int32), vals[:, :V].contiguous(), spill


def visit_order(o, d, lo, hi, V: int, count_max_dist=None):
    """(cids, entry, spill) of the V nearest clusters per ray: kernel 3 for
    CUDA tensors, the plain version for CPU tensors."""
    V, K = int(V), lo.shape[0]
    if not 1 <= V <= K:
        raise ValueError(f"visit_order: V={V} outside 1..K={K}")
    if o.device.type == "cpu":
        return visit_order_reference(o, d, lo, hi, V, count_max_dist)
    if o.device.type != "cuda":
        raise ValueError(f"visit_order: unsupported device {o.device}")
    R = o.shape[0]
    want = {"o": (o, (R, 3)), "d": (d, (R, 3)), "lo": (lo, (K, 3)),
            "hi": (hi, (K, 3))}
    if count_max_dist is not None:
        want["count_max_dist"] = (count_max_dist, (R,))
    for name, (x, shape) in want.items():
        if x.device != o.device or x.dtype != torch.float32:
            raise ValueError(f"visit_order: {name} must be float32 on "
                             f"{o.device}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"visit_order: {name} must be contiguous "
                             f"{shape}, got {tuple(x.shape)}")
    for name, x in (("lo", lo), ("hi", hi)):   # the bulk copies' sources
        if x.data_ptr() % 16:
            raise ValueError(f"visit_order: {name} must start 16-byte "
                             f"aligned")
    cids = torch.empty((R, V), dtype=torch.int32, device=o.device)
    entry = torch.empty((R, V), dtype=torch.float32, device=o.device)
    spill = torch.empty((R,), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        for col0, v in visit_passes(V):
            split = visit_split(R, K, v, _sm_count(o.device))
            err = _native.lib().crt_visit_order(
                o.data_ptr(), d.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                None if count_max_dist is None else count_max_dist.data_ptr(),
                cids.data_ptr(), entry.data_ptr(), spill.data_ptr(), R, K, V,
                col0, v, split.cluster, split.warps, split.slice, stream)
            _native.check(err, "visit_order")
            tracing.count("kernel.visit_order")
    return cids, entry, spill

"""The visit loop of the shared-origin shadow sweep (kernel 4).

``traverse.any_hit_tint_shared`` (the union sweep, the "shared"
shadow mode without a shortlist, each range of a sharded shadow sweep)
runs, for one chunk of light samples, every visit slot of every pixel:
gather the visited cluster's packed rows, Möller-Trumbore of the pixel's
shared origin against each sample, and fold the in-range lanes into the
samples' ``blocked`` and per-slot blocker counts.

* ``union_visits`` — on CUDA tensors it launches ``csrc/union_sweep.cu``,
  one launch for all the visits of a call; on CPU tensors it runs the
  plain version.  The kernel replaces no TPU kernel: the JAX package runs
  this loop as XLA ops.
* ``union_visits_reference`` — the plain PyTorch version, one visit step
  at a time, each step ~89 small ops on the card.
* ``check_inputs`` — what the kernel takes: the wrapper's refusals.

The outputs are masks and integer counts without gradient, as the plain
version's are: the kt gradient flows through ``Intersector.tint(counts)``.

Shapes: origin (P, 3) float32; cids (P, V) int64 and ok (P, V) bool from
a visit order; n_steps, the slots to run (``traverse._visit_limit``); d
(P, S, 3), md (P, S) float32 and ex (P, S) int64, the samples' directions,
segment ends and excluded primitive; acc the (P, S) bool ``blocked``, or
for a transparent pack (``blocked``, counts (P, S, n_slots) int16).
Returns the updated acc as new tensors.
"""

from __future__ import annotations

import torch

from c_raytracer_tpu_torch import _native
from c_raytracer_tpu_torch.accel import traverse
from c_raytracer_tpu_torch.core import tracing

MAX_SLOTS = 16   # transparent slots of the kernel's largest build


def union_visits_reference(cs, origin, cids, ok, n_steps: int, d, md, ex,
                           acc):
    """Plain PyTorch version of kernel 4, bit-exact with it."""
    C = cs.blk.shape[2]
    lanes = torch.arange(C, device=origin.device)
    for v in range(n_steps):
        cid = cids[:, v]
        live = ok[:, v]
        blk = cs.blk[cid]                                  # (P, F, C)
        gid = cs.gid0 + cid[:, None] * C + lanes
        t, hit = traverse._mt_block_multi(blk, origin, d)  # (P, S, C)
        in_range = (hit & live[:, None, None] & (t < md[..., None])
                    & (gid[:, None, :] != ex[..., None]))
        acc = traverse._fold_blockers(cs, acc, in_range, blk, gid[:, None],
                                      -1)
    return acc


def check_inputs(cs, origin, cids, ok, n_steps: int, d, md, ex, acc):
    """Raise ValueError unless kernel 4 takes these inputs: every tensor on
    origin's device, contiguous, of its dtype and shape; n_steps within
    0..V; at most ``MAX_SLOTS`` transparent slots."""
    P, S = md.shape[0], md.shape[-1]
    V = cids.shape[-1]
    K, F, C = cs.blk.shape
    blocked, counts = acc if cs.has_transp else (acc, None)
    want = {"origin": (origin, torch.float32, (P, 3)),
            "cids": (cids, torch.int64, (P, V)),
            "ok": (ok, torch.bool, (P, V)),
            "d": (d, torch.float32, (P, S, 3)),
            "md": (md, torch.float32, (P, S)),
            "ex": (ex, torch.int64, (P, S)),
            "blk": (cs.blk, torch.float32, (K, F, C)),
            "blocked": (blocked, torch.bool, (P, S))}
    if cs.has_transp:
        if cs.n_slots > MAX_SLOTS:
            raise ValueError(f"union_visits: {cs.n_slots} transparent slots,"
                             f" above the kernel's {MAX_SLOTS}")
        want["slot"] = (cs.slot, torch.int64, (K * C,))
        want["counts"] = (counts, torch.int16, (P, S, cs.n_slots))
    for name, (x, dtype, shape) in want.items():
        if x.device != origin.device or x.dtype != dtype:
            raise ValueError(f"union_visits: {name} must be {dtype} on "
                             f"{origin.device}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"union_visits: {name} must be contiguous "
                             f"{shape}, got {tuple(x.shape)}")
    if not 0 <= n_steps <= V:
        raise ValueError(f"union_visits: n_steps={n_steps} outside 0..{V}")


def kernel_args(cs, origin, cids, ok, n_steps: int, d, md, ex, acc, out,
                stream) -> tuple:
    """The arguments of ``crt_union_sweep`` for checked inputs and the
    output accumulator ``out`` (acc's shapes)."""
    blocked, counts = acc if cs.has_transp else (acc, None)
    b_out, c_out = out if cs.has_transp else (out, None)
    K, F, C = cs.blk.shape
    P, S = md.shape

    def ptr(x):
        return None if x is None else x.data_ptr()

    return (origin.data_ptr(), cids.data_ptr(), ok.data_ptr(), d.data_ptr(),
            md.data_ptr(), ex.data_ptr(), cs.blk.data_ptr(),
            ptr(cs.slot if cs.has_transp else None), blocked.data_ptr(),
            ptr(counts), b_out.data_ptr(), ptr(c_out), P, cids.shape[1],
            n_steps, S, F, C, cs.gid0, cs.n_slots if cs.has_transp else 0,
            stream)


def union_visits(cs, origin, cids, ok, n_steps: int, d, md, ex, acc):
    """The visit loop of one sample chunk: kernel 4 for CUDA tensors, the
    plain version for CPU tensors."""
    if origin.device.type == "cpu":
        return union_visits_reference(cs, origin, cids, ok, n_steps, d, md,
                                      ex, acc)
    if origin.device.type != "cuda":
        raise ValueError(f"union_visits: unsupported device {origin.device}")
    origin, d, md = origin.detach(), d.detach(), md.detach()
    check_inputs(cs, origin, cids, ok, n_steps, d, md, ex, acc)
    out = (tuple(torch.empty_like(a) for a in acc) if cs.has_transp
           else torch.empty_like(acc))
    if md.shape[0] == 0 or md.shape[1] == 0:
        return out
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream(origin.device).cuda_stream
        err = _native.lib().crt_union_sweep(*kernel_args(
            cs, origin, cids, ok, n_steps, d, md, ex, acc, out, stream))
    _native.check(err, "union_visits")
    tracing.count("kernel.union_sweep")
    return out

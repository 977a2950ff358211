"""The collectives of the mesh: what crosses ranks, and what it costs.

``gather`` stacks one tensor from every rank of a group on a new leading
axis, in rank order; ``all_reduce_sum`` sums in place.  Neither carries a
gradient: a collective inside the backward would run in the order the
autograd engine picks on each rank, which need not be one order.

``COUNTS`` holds the calls and the host seconds spent in them, for the
frame reports: ``reset()`` before a frame, read after.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

COUNTS = {"calls": 0, "seconds": 0.0}


def reset() -> None:
    COUNTS.update(calls=0, seconds=0.0)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, in place."""
    t0 = time.perf_counter()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    COUNTS["calls"] += 1
    COUNTS["seconds"] += time.perf_counter() - t0
    return x


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) of every rank's ``x`` in the rank order of ``group``,
    without gradient."""
    t0 = time.perf_counter()
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    COUNTS["calls"] += 1
    COUNTS["seconds"] += time.perf_counter() - t0
    return torch.stack(parts)

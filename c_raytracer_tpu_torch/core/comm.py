"""The collectives of the mesh: what crosses ranks, and what it costs.

``gather`` stacks one tensor from every rank of a group on a new leading
axis, in rank order; ``all_reduce_sum`` sums in place.  Neither carries a
gradient: a collective inside the backward would run in the order the
autograd engine picks on each rank, which need not be one order.

Each call is a span ``crt.comm.<op>`` and counts ``comm.calls``
(core/tracing.py): its host seconds are the span's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from c_raytracer_tpu_torch.core import tracing


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, in place."""
    with tracing.span("comm.all_reduce"):
        tracing.count("comm.calls")
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) of every rank's ``x`` in the rank order of ``group``,
    without gradient."""
    with tracing.span("comm.gather"):
        tracing.count("comm.calls")
        x = x.detach().contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

"""The rank mesh, as in ``c_raytracer_tpu.parallel.mesh``.

The reference's only parallelism is an OpenMP row loop (render.c:349-351).
Here the ranks of a ``torch.distributed`` group are laid out on three
axes, in the order the JAX package reshapes its devices:

* ``px`` — pixel tiles: each rank renders its own whole tiles;
* ``sp`` — Monte-Carlo samples: independent renders, averaged;
* ``pr`` — primitive ranges: the triangle arrays split into contiguous
  ranges, one a rank, the hit folds gathered across the ``pr`` group
  (geometry/sharded.py).

Rank ``r`` of the group sits at ``(px, sp, pr)`` with ``r = (px·n_sp + sp)
·n_pr + pr``.  The process group must be initialised first
(``parallel/launch.py`` does it, or ``torch.distributed.
init_process_group`` with an address, world size and rank); without one
only the 1×1×1 mesh exists, and it runs no collective.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch.distributed as dist

AXES = ("px", "sp", "pr")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (px, sp, pr) mesh and its process groups.

    ``shape`` and ``coord`` are indexed by ``AXES``; ``groups[a]`` is the
    process group of the ranks that differ from this one only on axis
    ``a`` (None where the axis has size 1); ``group`` is the whole mesh's
    group, None without ``torch.distributed``."""

    shape: tuple
    coord: tuple
    groups: tuple = (None, None, None)
    group: object = None
    distributed: bool = False

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return self.coord[AXES.index(axis)]

    def axis_group(self, axis: str):
        return self.groups[AXES.index(axis)]

    def rank_of(self, px: int, sp: int, pr: int) -> int:
        """The mesh rank (the rank in ``group``) at (px, sp, pr)."""
        return (px * self.shape[1] + sp) * self.shape[2] + pr


def make_mesh(n_px: int | None = None, n_sp: int = 1, n_pr: int = 1, *,
              group=None) -> Mesh:
    """The (px, sp, pr) mesh over the ranks of ``group`` (the default
    group when None).  By default every rank goes on ``px``.  A shape that
    does not cover the ranks raises ``ValueError``.

    Every rank must call this with the same arguments: it creates the
    subgroup of every line of every axis longer than 1, in one order on
    every rank, as ``torch.distributed.new_group`` demands."""
    if not (dist.is_available() and dist.is_initialized()):
        n = 1
        if n_px is None:
            n_px = n // (n_sp * n_pr)
        if (n_px, n_sp, n_pr) != (1, 1, 1):
            raise ValueError(f"mesh {n_px}x{n_sp}x{n_pr} != {n} devices "
                             "(no process group is initialised)")
        return Mesh(shape=(1, 1, 1), coord=(0, 0, 0))
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    n = len(ranks)
    if n_px is None:
        n_px = n // (n_sp * n_pr)
    if n_px * n_sp * n_pr != n or min(n_px, n_sp, n_pr) < 1:
        raise ValueError(f"mesh {n_px}x{n_sp}x{n_pr} != {n} devices")
    shape = (n_px, n_sp, n_pr)
    me = ranks.index(dist.get_rank())
    coord = (me // (n_sp * n_pr), me // n_pr % n_sp, me % n_pr)
    groups = []
    for a, size in enumerate(shape):
        if size == 1:
            groups.append(None)
            continue
        mine = None
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            line = []
            for k in range(size):
                c = list(rest)
                c.insert(a, k)
                line.append(ranks[(c[0] * n_sp + c[1]) * n_pr + c[2]])
            g = dist.new_group(line)
            if ranks[me] in line:
                mine = g
        groups.append(mine)
    return Mesh(shape=shape, coord=coord, groups=tuple(groups),
                group=group if group is not None else dist.group.WORLD,
                distributed=True)

"""Rematerialisation for the backward pass, as in
``c_raytracer_tpu.core.remat``.

The JAX package wraps each chain round and each light chunk in
``jax.checkpoint`` under the policy ``save_only_these_names("occlusion")``:
the backward recomputes a region's forward instead of keeping its
residuals, except for the occlusion masks.  Those are discrete (boolean,
no gradient of their own) and are exactly what the backward needs to route
cotangents through the ``where(ok, diffuse + spec, 0)`` selects, so keeping
them (1 byte a lane) lets the recompute skip the occlusion sweeps, which
dominate a frame.

Here the region boundary is ``torch.utils.checkpoint`` (non-reentrant, no
RNG state: every draw is an explicit Philox call keyed by its sample path,
so a recompute draws the same uniforms).  The named-residual policy is a
per-frame dict of occlusion results keyed by sample path (tile, round,
emitter[, chunk]): ``saved_occlusion`` runs the sweep on the forward and
serves the kept masks on every recompute.  In a scene with transparent
materials the sweep also returns, per sample, the count of in-range
blockers of each transparent material (int16); the recompute forms the
tint Π kt_m^count_m from the kept counts, so its gradient reaches
``materials.kt`` without a second sweep (geometry/primitives.py
``tint_from_counts``).  The dict hangs off the frame's
intersector, which the checkpointed regions hold, so it is freed with the
graph.

A region's tensors should reach it as arguments, not through a closure.
``checkpoint`` spreads V3s, tuples and dicts into positional tensors, which
``torch.utils.checkpoint`` saves as tensors: inside an enclosing checkpoint
those are themselves recomputed.  A closure, or a container passed whole,
would keep its tensors alive by reference until the backward: every light
chunk's samples of the whole frame.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree
import torch.utils.checkpoint

OCCLUSION = "occlusion"
DEFAULT_NAMES = (OCCLUSION,)


def check_names(names) -> None:
    """Refuse the JAX package's other named residuals (``shadow_samples``,
    ``shade_terms``), which are not ported."""
    if tuple(names) != DEFAULT_NAMES:
        raise NotImplementedError(
            f"remat_names={tuple(names)!r}: only ('occlusion',) is ported "
            "(ROADMAP: more remat names)")


def checkpoint(cfg, fn, *args):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    residuals when ``cfg.remat`` is on and autograd is recording.  The
    tensors inside ``args`` reach the checkpoint as positional arguments."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    flat, spec = pytree.tree_flatten(args)

    def region(*flat_args):
        return fn(*pytree.tree_unflatten(list(flat_args), spec))
    return torch.utils.checkpoint.checkpoint(
        region, *flat, use_reentrant=False, preserve_rng_state=False)


def saved_occlusion(saved: dict | None, path: tuple, sweep):
    """The occlusion result of the sample path ``path``: ``sweep()``, run
    without autograd (its masks carry no gradient, as the JAX package stops
    it at the sweep's inputs), on the first call; with ``saved`` (the
    frame's dict, or None to keep nothing) it is kept there and every later
    call, the recompute's, returns it without sweeping again."""
    if saved is not None and path in saved:
        return saved[path]
    with torch.no_grad():
        out = sweep()
    if saved is not None:
        saved[path] = out
    return out

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

The JAX package's two other named residuals, selected by
``RenderConfig.remat_names`` like ``"occlusion"``, map onto selective
checkpointing (``torch.utils.checkpoint``'s ``context_fn`` with
``create_selective_checkpoint_contexts``): code that computes a named
value runs inside ``with named(X):``, and while X is among the requested
names every op dispatched there is ``MUST_SAVE`` in every region around
it, the rest ``PREFER_RECOMPUTE``.  A recompute then takes those ops'
outputs from the forward instead of running them; the gradients are the
same.  ``shadow_samples`` covers the light samples' directions and
distances (render/shading.py ``_light_dirs``, from the drawn uniforms on:
the draw itself is recomputed), ``shade_terms`` the diffuse cosine and the
specular ``powf`` (``_shade_chunk``).  The JAX package saves only the
barrier'd values; a block here saves each op's output in it, which is why
the blocks hold no more than that computation.  Names this module does not
know save nothing, as in the JAX package, and the context is attached only
when a known name other than ``"occlusion"`` is asked for.  Without
``"occlusion"`` the frame keeps no occlusion dict (``saved_occlusion``
gets None) and the recompute sweeps again.

A region's tensors should reach it as arguments, not through a closure.
``checkpoint`` spreads V3s, tuples and dicts into positional tensors, which
``torch.utils.checkpoint`` saves as tensors: inside an enclosing checkpoint
those are themselves recomputed.  A closure, or a container passed whole,
would keep its tensors alive by reference until the backward: every light
chunk's samples of the whole frame.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.utils._pytree as pytree
import torch.utils.checkpoint
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from c_raytracer_tpu_torch.core import tracing

OCCLUSION = "occlusion"
SHADOW_SAMPLES = "shadow_samples"
SHADE_TERMS = "shade_terms"

# the name of the ``named`` block being computed, None outside one
_ACTIVE = contextvars.ContextVar("remat_name", default=None)


@contextlib.contextmanager
def named(name: str):
    """Mark the ops dispatched inside as computing the residual ``name``."""
    token = _ACTIVE.set(name)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@functools.lru_cache(maxsize=None)
def _context_fn(saved: frozenset):
    """The selective-checkpoint contexts that save the ops of ``named``
    blocks whose name is in ``saved``."""
    def policy(ctx, op, *args, **kwargs):
        if _ACTIVE.get() in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)


def checkpoint(cfg, fn, *args):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    residuals when ``cfg.remat`` is on and autograd is recording, keeping
    the values named by ``cfg.remat_names``.  The tensors inside ``args``
    reach the checkpoint as positional arguments.  A recompute runs in the
    span ``crt.remat.recompute`` (core/tracing.py)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    flat, spec = pytree.tree_flatten(args)

    def region(*flat_args):
        args = pytree.tree_unflatten(list(flat_args), spec)
        # run again while autograd runs a backward: the recompute
        if (tracing.enabled()
                and torch._C._current_autograd_node() is not None):
            with tracing.span("remat.recompute"):
                return fn(*args)
        return fn(*args)
    saved = frozenset(cfg.remat_names) & {SHADOW_SAMPLES, SHADE_TERMS}
    extra = {"context_fn": _context_fn(saved)} if saved else {}
    return torch.utils.checkpoint.checkpoint(
        region, *flat, use_reentrant=False, preserve_rng_state=False,
        **extra)


def saved_occlusion(saved: dict | None, path: tuple, sweep):
    """The occlusion result of the sample path ``path``: ``sweep()``, run
    without autograd (its masks carry no gradient, as the JAX package stops
    it at the sweep's inputs), on the first call; with ``saved`` (the
    frame's dict, or None to keep nothing) it is kept there and every later
    call, the recompute's, returns it without sweeping again."""
    if saved is not None and path in saved:
        return saved[path]
    if saved is None:
        with torch.no_grad():
            return sweep()
    # a recompute skips the sweep, so no checkpoint's dispatch mode may
    # count its ops: the selective contexts line the forward's ops up with
    # the recompute's by their order
    with torch.no_grad(), _disable_current_modes():
        out = sweep()
    saved[path] = out
    return out

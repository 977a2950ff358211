"""C99 float-semantics helpers, as in ``c_raytracer_tpu.core.cmath``.

* ``powf(negative, integral)`` is well-defined in C (render.c:224 uses
  ``powf(specular_mul, shininess)`` with possibly-negative bases) —
  ``torch.pow`` returns NaN there.
* ``fmaxf(0.f, NaN)`` returns 0 (C99 fmax ignores NaN) — ``torch.maximum``
  propagates NaN.
* ``signbit`` distinguishes -0.0 (render.c:167 ``is_outside``).
"""

from __future__ import annotations

import torch


def c_powf(base, exponent):
    """powf with C99 semantics for zero and negative bases.

    - base > 0: ordinary power
    - base == 0: 0^0 = 1, 0^pos = 0, 0^neg = inf
    - base < 0: integral exponent -> signed power, else NaN
    """
    base = torch.as_tensor(base, dtype=torch.float32)
    exponent = torch.as_tensor(exponent, dtype=torch.float32,
                               device=base.device)
    is_zero = base == 0.0
    safe = torch.where(is_zero, 1.0, torch.abs(base))
    mag_pow = safe ** exponent
    zero_val = torch.where(exponent > 0, 0.0,
                           torch.where(exponent == 0, 1.0, float("inf")))
    mag_pow = torch.where(is_zero, zero_val, mag_pow)
    is_integral = exponent == torch.floor(exponent)
    is_odd = torch.remainder(torch.abs(exponent), 2.0) == 1.0
    signed = torch.where(is_odd, -mag_pow, mag_pow)
    neg_result = torch.where(is_integral, signed, float("nan"))
    return torch.where(base < 0, neg_result, mag_pow)


def fmaxf_zero(x):
    """C ``fmaxf(0.f, x)``: returns 0 for NaN (render.c:205,224)."""
    return torch.where(x > 0, x, 0.0)


class _Fmax0Powf(torch.autograd.Function):
    """``fmaxf_zero(c_powf(x, s))`` on same-shaped operands, with the
    closed-form VJP of the JAX package's ``_fmax0_powf_bwd``."""

    @staticmethod
    def forward(ctx, x, s):
        p = fmaxf_zero(c_powf(x, s))
        ctx.save_for_backward(x, s, p)
        return p

    @staticmethod
    def backward(ctx, g):
        # On active lanes (p > 0, x != 0) p = ±|x|^s is positive, so
        # d/dx = s·p/x and d/ds = p·log|x|.  Inactive lanes (clamped to 0,
        # NaN, or x == 0, 0^neg = inf included) carry zero gradient; the
        # cotangent sits inside the select, so a NaN g there cannot leak.
        x, s, p = ctx.saved_tensors
        active = (p > 0) & (x != 0)
        safe_x = torch.where(x == 0, 1.0, x)
        dx = torch.where(active, s * p / safe_x * g, 0.0)
        ds = torch.where(active, p * torch.log(torch.abs(safe_x)) * g, 0.0)
        return dx, ds


def fmax0_powf(base, exponent):
    """``fmaxf(0.f, powf(base, exponent))`` — the specular clamp-power of
    render.c:205,224 — with a closed-form VJP: autograd through c_powf's
    select cascade would meet ``|x|^(s-1)`` as 0·inf on some lanes.  The
    operands are broadcast first, so the expand's backward sums the
    cotangent back to each operand's shape."""
    base = torch.as_tensor(base, dtype=torch.float32)
    exponent = torch.as_tensor(exponent, dtype=torch.float32,
                               device=base.device)
    shape = torch.broadcast_shapes(base.shape, exponent.shape)
    return _Fmax0Powf.apply(base.expand(shape), exponent.expand(shape))


def signbit(x):
    """IEEE signbit incl. -0.0 (render.c:167, object.c:481)."""
    return torch.signbit(x)

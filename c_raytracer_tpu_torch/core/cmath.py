"""C99 float-semantics helpers (forward), as in ``c_raytracer_tpu.core.cmath``.

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


def fmax0_powf(base, exponent):
    """``fmaxf(0.f, powf(base, exponent))`` — the specular clamp-power of
    render.c:205,224."""
    return fmaxf_zero(c_powf(base, exponent))


def signbit(x):
    """IEEE signbit incl. -0.0 (render.c:167, object.c:481)."""
    return torch.signbit(x)

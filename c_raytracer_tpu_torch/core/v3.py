"""Structure-of-arrays 3-vectors on tensors.

The counterpart of ``c_raytracer_tpu.core.v3``: x/y/z live as three
same-shaped tensors with the big (pixel / ray) axis last, so every
elementwise op reads contiguous memory and the public (..., 3) layouts
convert once at the seams (``from_aos`` / ``to_aos``).  Helpers mirror the
reference's calc.c ops.  Scalars (Python floats or 0-d tensors) broadcast
per component.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PI = float(np.float32(3.1415927))  # type.h:32, a float32 value


class V3(NamedTuple):
    """Three same-shaped component tensors (or scalars)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        """Componentwise with V3 (calc.c mul3v), scalar else (mul3s)."""
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def map(self, f):
        return V3(f(self.x), f(self.y), f(self.z))


def dot(a: V3, b: V3):
    """dot3 (calc.c)."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    """cross (calc.c)."""
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def magsqr(a: V3):
    return a.x * a.x + a.y * a.y + a.z * a.z


def sqrt(x):
    """Correctly rounded float32 sqrt, as C's sqrtf and XLA give it.
    torch's vectorized CPU sqrt can be one ulp off, which the cancellation
    in the sphere discriminant turns into 1e-6-relative hit distances; the
    square root of the float64 value rounds once to the exact result."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def safe_mag(a: V3):
    """Magnitude, 0 for the zero vector (the JAX package's double-where)."""
    m2 = magsqr(a)
    ok = m2 > 0
    return torch.where(ok, sqrt(torch.where(ok, m2, 1.0)), 0.0)


def where(m, a, b) -> V3:
    """Componentwise select; ``m`` broadcasts against the components; a
    scalar operand stands for the same value in every component."""
    if not isinstance(a, V3):
        a = V3(a, a, a)
    if not isinstance(b, V3):
        b = V3(b, b, b)
    return V3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
              torch.where(m, a.z, b.z))


def splat(v) -> V3:
    """A (3,) tensor (one table row) -> V3 of 0-d tensors."""
    return V3(v[0], v[1], v[2])


def full(shape, v, *, device) -> V3:
    return V3(*(torch.full(shape, v, dtype=torch.float32, device=device)
                for _ in range(3)))


def from_aos(arr) -> V3:
    """(..., 3) -> V3 of (...,) components."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])


def to_aos(v: V3):
    """V3 -> (..., 3)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def rows(table, idx) -> V3:
    """(M, 3) table rows picked per lane by integer ``idx`` -> V3.  A gather
    from a tiny table: the natural GPU form of the JAX package's unrolled
    selects (v3.select_v3), with the same values."""
    g = table[idx]
    return V3(g[..., 0], g[..., 1], g[..., 2])


def spherical_to_cartesian(radius, inclination, azimuth) -> V3:
    """SPHERICAL_TO_CARTESIAN macro (calc.h:17-22)."""
    si, ci = torch.sin(inclination), torch.cos(inclination)
    sa, ca = torch.sin(azimuth), torch.cos(azimuth)
    return V3(radius * ca * si, radius * sa * si, radius * ci)

"""3D simplex noise on tensors, as in ``c_raytracer_tpu.core.noise``.

Stefan Gustavson's public-domain 3D simplex noise, which the reference
vendors (SimplexNoise.c:99-194); "noisy periodic" textures feed hit points
through it, so the permutation table and the arithmetic match the JAX
package's.  Branchless: the simplex-corner ordering is a truth table of
rank comparisons, and the hash is a gather from the 256-entry table.
"""

from __future__ import annotations

import numpy as np
import torch

from c_raytracer_tpu_torch.core import tracing

# Ken Perlin's canonical permutation table (public domain).
_PERM = np.array([
    151, 160, 137, 91, 90, 15,
    131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23,
    190, 6, 148, 247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32, 57, 177, 33,
    88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165, 71, 134, 139, 48, 27, 166,
    77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244,
    102, 143, 54, 65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169, 200, 196,
    135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64, 52, 217, 226, 250, 124, 123,
    5, 202, 38, 147, 118, 126, 255, 82, 85, 212, 207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42,
    223, 183, 170, 213, 119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104, 218, 246, 97, 228,
    251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81, 51, 145, 235, 249, 14, 239, 107,
    49, 192, 214, 31, 181, 199, 106, 157, 184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254,
    138, 236, 205, 93, 222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], dtype=np.int64)

_F3 = float(np.float32(1.0 / 3.0))
_G3 = float(np.float32(1.0 / 6.0))
_G3x2 = float(np.float32(2.0) * np.float32(_G3))
_G3x3 = float(np.float32(3.0) * np.float32(_G3))


def _grad(h, x, y, z):
    """Gradient dot residual for the low 4 bits of a hash
    (SimplexNoise.c:82-88), branchless."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def simplex_noise(x, y, z):
    """Batched 3D simplex noise in [-1, 1]; 0 at all integer coordinates."""
    tracing.count("sync.noise_perm")   # the table copied from the host
    perm = torch.as_tensor(_PERM, device=x.device)

    def hash_(i):
        return perm[i & 255]  # perm[(uint8)i] (SimplexNoise.c:31)

    s = (x + y + z) * _F3
    i = torch.floor(x + s).to(torch.int64)
    j = torch.floor(y + s).to(torch.int64)
    k = torch.floor(z + s).to(torch.int64)
    t = (i + j + k).to(torch.float32) * _G3
    x0 = x - (i.to(torch.float32) - t)
    y0 = y - (j.to(torch.float32) - t)
    z0 = z - (k.to(torch.float32) - t)

    # the six simplex orderings (SimplexNoise.c:124-140)
    x_ge_y = x0 >= y0
    y_ge_z = y0 >= z0
    x_ge_z = x0 >= z0
    c_xyz = x_ge_y & y_ge_z
    c_xzy = x_ge_y & ~y_ge_z & x_ge_z
    c_zxy = x_ge_y & ~y_ge_z & ~x_ge_z
    c_zyx = ~x_ge_y & ~y_ge_z
    c_yzx = ~x_ge_y & y_ge_z & ~x_ge_z
    c_yxz = ~x_ge_y & y_ge_z & x_ge_z

    def pick(*vals):
        out = torch.zeros_like(i)
        for c, v in zip((c_xyz, c_xzy, c_zxy, c_zyx, c_yzx, c_yxz), vals):
            if v:
                out = out + c.to(torch.int64)
        return out

    i1, j1, k1 = pick(1, 1, 0, 0, 0, 0), pick(0, 0, 0, 0, 1, 1), \
        pick(0, 0, 1, 1, 0, 0)
    i2, j2, k2 = pick(1, 1, 1, 0, 0, 1), pick(1, 0, 0, 1, 1, 1), \
        pick(0, 1, 1, 1, 1, 0)

    x1 = x0 - i1.to(torch.float32) + _G3
    y1 = y0 - j1.to(torch.float32) + _G3
    z1 = z0 - k1.to(torch.float32) + _G3
    x2 = x0 - i2.to(torch.float32) + _G3x2
    y2 = y0 - j2.to(torch.float32) + _G3x2
    z2 = z0 - k2.to(torch.float32) + _G3x2
    x3 = x0 - 1.0 + _G3x3
    y3 = y0 - 1.0 + _G3x3
    z3 = z0 - 1.0 + _G3x3

    gi0 = hash_(i + hash_(j + hash_(k)))
    gi1 = hash_(i + i1 + hash_(j + j1 + hash_(k + k1)))
    gi2 = hash_(i + i2 + hash_(j + j2 + hash_(k + k2)))
    gi3 = hash_(i + 1 + hash_(j + 1 + hash_(k + 1)))

    def corner(gi, cx, cy, cz):
        t_ = 0.6 - cx * cx - cy * cy - cz * cz
        t2 = t_ * t_
        n = t2 * t2 * _grad(gi, cx, cy, cz)
        return torch.where(t_ < 0, 0.0, n)

    n0 = corner(gi0, x0, y0, z0)
    n1 = corner(gi1, x1, y1, z1)
    n2 = corner(gi2, x2, y2, z2)
    n3 = corner(gi3, x3, y3, z3)
    return 32.0 * (n0 + n1 + n2 + n3)

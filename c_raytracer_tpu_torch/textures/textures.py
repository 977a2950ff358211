"""Procedural textures over a per-material parameter table, as in
``c_raytracer_tpu.textures.textures``.

Texture parameter packing (scene/types.py Materials):
  uniform:         tex_color = color
  checkerboard:    tex_color/tex_color2 = colors[0]/[1], tex_scale = scale
  brick:           + tex_p1 = mortar width
  noisy periodic:  tex_color = base color, tex_color2 = color gradient,
                   tex_scale = noise feature scale, tex_p1 = noise scale,
                   tex_p2 = frequency scale, func = periodic function id
"""

from __future__ import annotations

import torch

from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.noise import simplex_noise
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.scene import types as T


def texture_color_soa(materials: T.Materials, static, mat, point: V3) -> V3:
    """Texture color per lane.

    ``mat``: (P,) material index; ``point``: V3 (P,) world hit points.
    Each material's texture family is known on the host (``static``), so
    the loop over the (tiny) material table evaluates each family with its
    material's scalar parameters and blends by ``mat == m``.
    """
    out = v3m.full(mat.shape, 0.0, device=mat.device)
    for m, tt in enumerate(static.tex_type):
        c0 = v3m.splat(materials.tex_color[m])
        if tt == T.TEX_UNIFORM:
            col = c0
        elif tt == T.TEX_CHECKERBOARD:
            c1 = v3m.splat(materials.tex_color2[m])
            sp = point * materials.tex_scale[m]
            # C float->uint cast truncates toward zero (material.c:159-166)
            parity = (sp.x.to(torch.int32) + sp.y.to(torch.int32)
                      + sp.z.to(torch.int32)) % 2
            col = v3m.where(parity != 0, c1, c0)
        elif tt == T.TEX_BRICK:
            c1 = v3m.splat(materials.tex_color2[m])
            sp = point * materials.tex_scale[m]
            mortar = materials.tex_p1[m]
            par = (sp.x.to(torch.int32) % 2).to(torch.float32)
            y = sp.y - par * 0.5
            is_mortar = ((sp.x - torch.floor(sp.x) < mortar)
                         | (y - torch.floor(y) < mortar))
            col = v3m.where(is_mortar, c1, c0)
        else:  # TEX_NOISY_PERIODIC (material.c:179-200)
            grad = v3m.splat(materials.tex_color2[m])
            sp = point * materials.tex_scale[m]
            n = simplex_noise(sp.x, sp.y, sp.z)
            angle = (point.x + n * materials.tex_p1[m]) * materials.tex_p2[m]
            fid = static.tex_func[m]
            if fid == T.FUNC_SIN:
                env = (1.0 + torch.sin(angle)) * 0.5
            elif fid == T.FUNC_SAW:
                env = angle - torch.floor(angle)
            elif fid == T.FUNC_TRIANGLE:
                env = torch.abs(2.0 * (angle - torch.floor(angle) - 0.5))
            else:  # FUNC_SQUARE
                env = (~torch.signbit(torch.sin(angle))).to(torch.float32)
            col = grad * env + c0
        out = v3m.where(mat == m, col, out)
    return out

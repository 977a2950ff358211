"""Postprocessing effects (the reference's separate ``postprocess`` binary,
postproc.c:36-188), as in ``c_raytracer_tpu.postprocess.ops``: plain torch
image ops on the tensors' device.

Depth of field is the reference's forward-mapped z-buffer scatter — each
source pixel splats pixel·α over its circle-of-confusion disc onto pixels
at greater-or-equal depth, then the sum is normalised by the accumulated α
(postproc.c:104-164) — in the JAX package's gather form: for every
destination pixel, a sum over the source offsets (dy, dx) within the
largest CoC radius, accepting a source when the offset lies inside the
source's own rasterised disc and the source is no deeper.  The offsets
are the JAX package's static list in its order, one rolled (h, w, 6)
plane each, so on the CPU the sums are taken in JAX's order.
"""

from __future__ import annotations

import numpy as np
import torch

from c_raytracer_tpu_torch.core import v3 as v3m


def brighten(image, factor):
    """Scalar multiply (postproc.c:94-102)."""
    return image * np.float32(factor)


def mist(image, z_buffer, start, depth, falloff, color):
    """Depth-based fog blend (postproc.c:166-188).

    falloff: "lin" | "quad" | "inv_quad" (sqrt).
    """
    opacity = torch.clamp((z_buffer - start) * (1.0 / depth), 0.0, 1.0)
    if falloff == "quad":
        opacity = opacity * opacity
    elif falloff == "inv_quad":
        opacity = v3m.sqrt(opacity)
    elif falloff != "lin":
        raise ValueError(f"Unrecognized falloff type [{falloff}].")
    color = torch.as_tensor(color, dtype=torch.float32, device=image.device)
    return (image * (1.0 - opacity)[..., None]
            + color * opacity[..., None])


def dof_camera_params(z_buffer, aperture, focal_length, plane_in_focus):
    """--dof-camera scale/bias derivation (postproc.c:52-68)."""
    z_min = float(torch.min(z_buffer))
    z_max = float(torch.max(z_buffer))
    scale = ((aperture * focal_length * plane_in_focus * (z_max - z_min))
             / ((plane_in_focus - focal_length) * z_min * z_max))
    bias = ((aperture * focal_length * (z_min - plane_in_focus))
            / ((plane_in_focus * focal_length) * z_min))
    return scale, bias


def disc_offsets(max_radius: int) -> list[tuple[int, int]]:
    """The (dy, dx) offsets of the rasterised disc of radius
    ``max_radius``, in the JAX package's order: dx ascending, dy ascending
    within it, |dy| <= int(sqrt(R² - dx²))."""
    R = int(max_radius)
    return [(dy, dx)
            for dx in range(-R, R + 1)
            for dy in range(-int(np.sqrt(R * R - dx * dx)),
                            int(np.sqrt(R * R - dx * dx)) + 1)]


def coc_radius(z_buffer, scale, bias):
    """Per-pixel CoC radius int(|z·scale + bias|·0.5), int32; as XLA's
    float-to-int conversion, NaN gives 0 and a huge value saturates."""
    half = torch.abs(z_buffer * scale + bias) * 0.5
    half = torch.nan_to_num(half, nan=0.0).clamp(max=2147483520.0)
    return half.to(torch.int32)


def depth_of_field(image, z_buffer, scale, bias,
                   *, max_radius: int | None = None):
    """Forward-mapped z-buffer DoF (postproc.c:104-164), gather form.

    Per source pixel: CoC radius r = int(|depth·scale+bias|·0.5),
    α = min(1/r², 1); the splat covers integer offsets x ∈ [−r, r],
    y ∈ [−hh, hh] with hh = int(sqrt(r²−x²)), only onto destinations with
    depth ≥ source depth; destination value = Σ(pixel·α) / Σα.

    One pass per offset of the radius-``max_radius`` disc
    (``disc_offsets``), each rolling ONE fused (h, w, 6) plane (weighted
    rgb, α, z, r).  ``max_radius`` None reads the largest radius from the
    z-buffer (one host read); a smaller bound truncates the sources with a
    larger CoC (their offsets beyond the window are dropped).
    """
    h, w, _ = image.shape
    z = z_buffer.reshape(h, w)
    radius = coc_radius(z, scale, bias)
    if max_radius is None:
        max_radius = int(radius.max())
    r_f = radius.to(torch.float32)
    alpha = torch.minimum(1.0 / torch.clamp(r_f * r_f, min=1.0),
                          torch.ones_like(r_f))
    # NOTE r==0: the reference computes 1/0² = inf, MIN(inf,1)=1 → α=1
    alpha = torch.where(radius == 0, 1.0, alpha)

    # fused source plane: rgb·α | α | z | r   (one roll per offset)
    stacked = torch.cat([image * alpha[..., None], alpha[..., None],
                         z[..., None], r_f[..., None]], dim=-1)
    yy = torch.arange(h, device=image.device)[:, None]
    xx = torch.arange(w, device=image.device)[None, :]

    acc = torch.zeros_like(image)
    asum = torch.zeros((h, w), dtype=torch.float32, device=image.device)
    for dy, dx in disc_offsets(max_radius):
        s = torch.roll(stacked, (dy, dx), dims=(0, 1))
        src_w, src_a = s[..., :3], s[..., 3]
        src_z, src_r = s[..., 4], s[..., 5]
        # source's own rasterized disc: |dx| <= r, |dy| <= int(sqrt(r²-dx²))
        dxf = float(dx)
        hh = torch.floor(v3m.sqrt(torch.clamp(src_r * src_r - dxf * dxf,
                                              min=0.0)))
        in_disc = (abs(dxf) <= src_r) & (abs(dy) <= hh)
        # reference bounds-checks instead of wrapping (postproc.c:124-140)
        in_bounds = ((yy - dy >= 0) & (yy - dy < h)
                     & (xx - dx >= 0) & (xx - dx < w))
        ok = in_disc & in_bounds & (src_z <= z)
        acc = acc + torch.where(ok[..., None], src_w, 0.0)
        asum = asum + torch.where(ok, src_a, 0.0)
    # normalize (postproc.c:160-161); α sum is 0 only where nothing splatted
    return acc / torch.where(asum > 0, asum, 1.0)[..., None]

"""Fused soft-shadow chunk (kernel 2), as in
``c_raytracer_tpu.render.fused_shadow``.

One light-sample chunk of ``shading.direct_light`` for a sphere emitter in a
dense opaque scene — emitter point sampling from the pre-drawn uniforms,
the sphere/plane occlusion sweep, attenuation, diffuse and Phong/Blinn
specular, and the masked sum over the chunk's samples (render.c:170-229) —
in one CUDA kernel (``csrc/fused_shadow.cu``), which replaces the Pallas
kernel of ``c_raytracer_tpu/render/fused_shadow.py`` (``_run``/``_kernel``).

On the H100 the chunk is bound by the ALU (four sin/cos, two sqrt, a powf
and the occluder tests per sample against 8 bytes of uniforms read).  A
block holds 32 pixels, one per lane, and 8 warps; each warp takes every
8th sample of its pixels, and the warps' partial sums are added in warp
order in shared memory, so nothing between the uniform draw and the (3, P)
sums goes to device memory.

Packed operands, as in the JAX package: ``u (2, lc, P)`` uniforms,
``px (17, P)`` per-pixel rows (hit point, normal, ray direction, texture
colour, ks, shininess, okf), ``scal_f (8 + 5·ns + 5·npl,)`` scene scalars
(emitter centre, radius, intensity, attenuation offset, then
[cx cy cz r eps] per sphere and [nx ny nz d eps] per plane), ``n_valid``
the number of real samples in the chunk.  Output ``(3, P)``.

The uniforms are an explicit input so that the backward (the plain
version, differentiated by autograd at the same ``u``) sees the forward's
sample set, mirroring ``make_fused_chunk``'s ``custom_vjp``.
"""

from __future__ import annotations

import torch

from c_raytracer_tpu_torch import _native
from c_raytracer_tpu_torch.core import cmath, tracing
from c_raytracer_tpu_torch.core import v3 as v3m
from c_raytracer_tpu_torch.core.v3 import V3
from c_raytracer_tpu_torch.geometry import primitives as G
from c_raytracer_tpu_torch.render import shading

EMIT_F = 8            # emitter floats at the head of scal_f
PX_ROWS = 17
ATTEN_KINDS = {"none": 0, "lin": 1, "sqr": 2}


def fused_chunk_reference(u, px, scal_f, n_valid: int, *, lc, ns, npl, egid,
                          phong, atten_kind):
    """Plain PyTorch version of kernel 2: the torch form of
    ``c_raytracer_tpu/render/shading.py`` ``_packed_sphere_chunk_ref``."""
    hit_pt = V3(px[0], px[1], px[2])
    normal = V3(px[3], px[4], px[5])
    ray_d = V3(px[6], px[7], px[8])
    tex = V3(px[9], px[10], px[11])
    ks = V3(px[12], px[13], px[14])
    shin = px[15]
    okf = px[16] > 0
    ec = V3(scal_f[0], scal_f[1], scal_f[2])
    erad = scal_f[3]
    inten = V3(scal_f[4], scal_f[5], scal_f[6])
    off = scal_f[7]

    def b(x):  # (P,) -> (1, P) against the (lc, P) sample lanes
        return x[None]

    lp = shading._sphere_light_point_from_u(u, ec, erad, hit_pt)
    lvec = lp - hit_pt.map(b)
    ldist = v3m.safe_mag(lvec)
    ldir = lvec * (1.0 / torch.where(ldist == 0.0, 1.0, ldist))
    nrm_b = normal.map(b)
    a = v3m.dot(ldir, nrm_b)

    o_b = hit_pt.map(b)
    blocked = torch.zeros(u.shape[1:], dtype=torch.bool, device=u.device)
    for i in range(ns):
        if i == egid:
            continue
        base = EMIT_F + 5 * i
        c = V3(scal_f[base], scal_f[base + 1], scal_f[base + 2])
        t, hit = G._sphere_test_soa(o_b, ldir, c, scal_f[base + 3],
                                    scal_f[base + 4])
        blocked = blocked | (hit & (t < ldist))
    for i in range(npl):
        base = EMIT_F + 5 * ns + 5 * i
        n = V3(scal_f[base], scal_f[base + 1], scal_f[base + 2])
        t, hit, _ = G._plane_test_soa(o_b, ldir, n, scal_f[base + 3],
                                      scal_f[base + 4])
        blocked = blocked | (hit & (t < ldist))

    if atten_kind == "none":
        att = torch.ones_like(ldist)
    elif atten_kind == "lin":
        att = 1.0 / (off + ldist)
    else:
        att = 1.0 / (off + ldist * ldist)
    incoming = inten * att

    rd_b = ray_d.map(b)
    if phong:
        reflected = nrm_b * (2.0 * a) - ldir
        spec_mul = -v3m.dot(reflected, rd_b)
    else:
        hv = rd_b - ldir
        hm = v3m.safe_mag(hv)
        reflected = hv * (1.0 / torch.where(hm == 0.0, 1.0, hm))
        spec_mul = -v3m.dot(nrm_b, reflected)
    cos_d = cmath.fmaxf_zero(a)
    spec_p = cmath.fmax0_powf(spec_mul, shin[None])

    lane = torch.arange(u.shape[1], device=u.device)[:, None]
    ok = okf[None] & ~blocked & (lane < n_valid)
    diffuse = tex.map(b) * incoming * cos_d
    spec = ks.map(b) * incoming * spec_p
    contrib = v3m.where(ok, diffuse + spec, 0.0)
    return torch.stack([contrib.x.sum(0), contrib.y.sum(0),
                        contrib.z.sum(0)], dim=0)


def _launch(u, px, scal_f, n_valid: int, *, lc, ns, npl, egid, phong,
            atten_kind):
    """Check the operands and launch kernel 2 on the current stream."""
    P = px.shape[-1]
    want = {"u": (u, (2, lc, P)), "px": (px, (PX_ROWS, P)),
            "scal_f": (scal_f, (EMIT_F + 5 * ns + 5 * npl,))}
    for name, (x, shape) in want.items():
        if x.device != u.device or x.dtype != torch.float32:
            raise ValueError(f"fused_chunk: {name} must be float32 on "
                             f"{u.device}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"fused_chunk: {name} must be contiguous "
                             f"{shape}, got {tuple(x.shape)}")
    out = torch.empty((3, P), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _native.lib().crt_fused_shadow_chunk(
            u.data_ptr(), px.data_ptr(), scal_f.data_ptr(), out.data_ptr(),
            P, lc, int(n_valid), ns, npl, egid, int(bool(phong)),
            ATTEN_KINDS[atten_kind], scal_f.numel(), stream)
    _native.check(err, "fused_chunk")
    tracing.count("kernel.fused_shadow")
    return out


class _FusedChunk(torch.autograd.Function):
    """Kernel forward; backward differentiates the plain version at the
    same u, px and scal_f, on their device (a backward kernel is later
    work).  It keeps those three operands and nothing else: the backward
    recomputes the occlusion and shading it needs."""

    @staticmethod
    def forward(ctx, u, px, scal_f, n_valid, statics):
        ctx.save_for_backward(u, px, scal_f)
        ctx.n_valid, ctx.statics = n_valid, statics
        return _launch(u, px, scal_f, n_valid, **statics)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(n) for x, n in zip(saved, needs)]
            out = fused_chunk_reference(*inputs, ctx.n_valid, **ctx.statics)
            wrt = [x for x, n in zip(inputs, needs) if n]
            got = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        grads = [next(got) if n else None for n in needs]
        return (*grads, None, None)


def fused_chunk(u, px, scal_f, n_valid: int, *, lc, ns, npl, egid, phong,
                atten_kind):
    """One soft-shadow chunk -> (3, P): kernel 2 for CUDA tensors, the plain
    version for CPU tensors."""
    statics = dict(lc=lc, ns=ns, npl=npl, egid=egid, phong=phong,
                   atten_kind=atten_kind)
    if u.device.type == "cpu":
        return fused_chunk_reference(u, px, scal_f, n_valid, **statics)
    if u.device.type != "cuda":
        raise ValueError(f"fused_chunk: unsupported device {u.device}")
    return _FusedChunk.apply(u, px, scal_f, n_valid, statics)

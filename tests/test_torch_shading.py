"""C-semantics math, textures and the fused soft-shadow chunk's plain
version (kernel 2's CPU form) against the JAX package's, on the same NumPy
inputs.  The JAX side runs op by op (not jitted), as its own tests run
these functions on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.core import cmath as jcm
from c_raytracer_tpu.core import noise as jnoise
from c_raytracer_tpu.core import v3 as jv3
from c_raytracer_tpu.render import shading as jsh
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu.textures import texture_color_soa as jax_texture
from c_raytracer_tpu_torch.core import cmath as tcm
from c_raytracer_tpu_torch.core import v3 as tv3
from c_raytracer_tpu_torch.render import fused_shadow
from c_raytracer_tpu_torch.scene import params_to_torch
from c_raytracer_tpu_torch.textures import texture_color_soa


def _grid():
    bases = np.array([-2.5, -1.0, -0.7, -0.0, 0.0, 1e-30, 0.3, 0.999, 1.0,
                      1.7, 40.0, np.nan], np.float32)
    exps = np.array([-3.0, -1.5, 0.0, 0.5, 1.0, 2.0, 3.0, 7.5, 32.0, 120.0],
                    np.float32)
    b, e = np.meshgrid(bases, exps, indexing="ij")
    return b.ravel(), e.ravel()


@pytest.mark.parametrize("fn", ["c_powf", "fmax0_powf", "fmaxf_zero",
                                "signbit"])
def test_cmath_matches_jax(fn):
    b, e = _grid()
    if fn in ("c_powf", "fmax0_powf"):
        want = np.asarray(getattr(jcm, fn)(jnp.asarray(b), jnp.asarray(e)))
        got = getattr(tcm, fn)(torch.from_numpy(b), torch.from_numpy(e))
    else:
        want = np.asarray(getattr(jcm, fn)(jnp.asarray(b)))
        got = getattr(tcm, fn)(torch.from_numpy(b))
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    if got.dtype == np.bool_:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


_FUNCS = ("sin", "saw", "triangle", "square")


def _texture_scene():
    mats = [dict(tex_type=0, tex_color=[0.2, 0.4, 0.6]),
            dict(tex_type=1, tex_color=[0.9, 0.9, 0.9],
                 tex_color2=[0.1, 0.1, 0.2], tex_scale=1.5),
            dict(tex_type=2, tex_color=[0.7, 0.3, 0.2],
                 tex_color2=[0.9, 0.9, 0.8], tex_scale=2.0, tex_p1=0.1)]
    mats += [dict(tex_type=3, tex_func=f, tex_color=[0.1, 0.2, 0.3],
                  tex_color2=[0.5, 0.4, 0.3], tex_scale=1.3, tex_p1=0.8,
                  tex_p2=2.5) for f in range(4)]
    mats.append(dict(ke=[1, 1, 1], tex_type=0, tex_color=[1, 1, 1]))
    return jax_make_scene(
        sphere_center=[[0, 0, 0]], sphere_radius=[1.0], sphere_material=[7],
        materials=mats,
        camera=dict(position=[0, 0, -5], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=60, focal_length=1))


def _away(x, tol=1e-3):
    """Distance of x from the nearest integer is at least tol."""
    f = x - np.floor(x)
    return (f > tol) & (f < 1 - tol)


@pytest.mark.parametrize("m,name", [(0, "uniform"), (1, "checkerboard"),
                                    (2, "brick")]
                         + [(3 + i, f"noisy_{f}") for i, f in
                            enumerate(_FUNCS)])
def test_texture_matches_jax(m, name):
    sc = _texture_scene()
    p = np.random.default_rng(m).uniform(-4, 4, size=(3, 4096))
    p = p.astype(np.float32)
    mats = sc.params.materials
    sp = p * mats.tex_scale[m]
    if name in ("checkerboard", "brick"):
        keep = _away(sp[0]) & _away(sp[1]) & _away(sp[2])
        if name == "brick":
            par = (sp[0].astype(np.int32) % 2).astype(np.float32)
            y = sp[1] - par * 0.5
            mortar = mats.tex_p1[m]
            keep &= (np.abs(sp[0] - np.floor(sp[0]) - mortar) > 1e-3) \
                & (np.abs(y - np.floor(y) - mortar) > 1e-3) & _away(y)
    elif name.startswith("noisy"):
        n = np.asarray(jnoise.simplex_noise(*sp))
        angle = (p[0] + n * mats.tex_p1[m]) * mats.tex_p2[m]
        keep = _away(angle) & (np.abs(np.sin(angle)) > 1e-3)
    else:
        keep = np.ones(p.shape[1], bool)
    p = p[:, keep]
    mat = np.full(p.shape[1], m, np.int32)

    want = jax_texture(mats, sc.static, jnp.asarray(mat),
                       jv3.V3(*(jnp.asarray(c) for c in p)))
    got = texture_color_soa(params_to_torch(sc.params, "cpu").materials,
                            sc.static, torch.from_numpy(mat.astype(np.int64)),
                            tv3.V3(*(torch.from_numpy(c) for c in p)))
    want = np.stack([np.asarray(c) for c in want])
    got = np.stack([c.numpy() for c in got])
    assert p.shape[1] > 3000
    if name.startswith("noisy"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def _chunk_inputs(seed, lc, P, ns, npl, egid):
    """u (2, lc, P), px (17, P), scal_f: hit points on a ground region
    below a sphere emitter with occluding spheres and planes around."""
    r = np.random.default_rng(seed)
    hit = r.uniform(-3, 3, size=(3, P))
    hit[1] = r.uniform(-1, 1, size=P)
    nrm = r.normal(size=(3, P))
    nrm /= np.linalg.norm(nrm, axis=0)
    nrm[:, : P // 2] = np.abs(nrm[:, : P // 2]) * [[0], [1], [0]] + \
        nrm[:, : P // 2] * [[1], [0], [1]]
    nrm /= np.linalg.norm(nrm, axis=0)
    rd = r.normal(size=(3, P))
    rd /= np.linalg.norm(rd, axis=0)
    tex = r.uniform(0, 1, size=(3, P))
    ks = r.uniform(0, 1, size=(3, P))
    shin = r.choice([1.0, 8.0, 32.0, 120.0, 7.5], size=(1, P))
    okf = (r.uniform(size=(1, P)) < 0.8).astype(np.float64)
    px = np.concatenate([hit, nrm, rd, tex, ks, shin, okf]).astype(np.float32)

    centers = r.normal(size=(ns, 3)) * 1.5
    centers[egid] = [0.3, 6.0, -0.5]
    radii = r.uniform(0.3, 0.9, size=ns)
    radii[egid] = 1.0
    scal = [*centers[egid], radii[egid], 18.0 / 200, 18.0 / 200, 16.0 / 200,
            1.0]
    for i in range(ns):
        scal += [*centers[i], radii[i], radii[i] * 3e-4]
    pn = r.normal(size=(npl, 3))
    pn /= np.linalg.norm(pn, axis=1, keepdims=True)
    for i in range(npl):
        scal += [*pn[i], -4.0 - i, 1e-6]
    u = r.uniform(size=(2, lc, P)).astype(np.float32)
    return u, px, np.asarray(scal, np.float32)


@pytest.mark.parametrize("phong", [True, False], ids=["phong", "blinn"])
@pytest.mark.parametrize("atten", ["none", "lin", "sqr"])
@pytest.mark.parametrize("lc,n_valid", [(40, 40), (16, 12)],
                         ids=["full", "tail"])
def test_fused_chunk_reference_matches_jax(phong, atten, lc, n_valid):
    ns, npl, egid, P = 4, 2, 2, 1024
    u, px, scal_f = _chunk_inputs(lc + n_valid, lc, P, ns, npl, egid)
    ref = jsh._packed_sphere_chunk_ref(phong, lc, ns, npl, egid, atten)
    want = np.asarray(ref(jnp.asarray(u), jnp.asarray(px),
                          jnp.asarray(scal_f), jnp.asarray([n_valid])))
    got = fused_shadow.fused_chunk(
        torch.from_numpy(u), torch.from_numpy(px), torch.from_numpy(scal_f),
        n_valid, lc=lc, ns=ns, npl=npl, egid=egid, phong=phong,
        atten_kind=atten).numpy()
    assert got.shape == (3, P)
    assert want.max() > 0 and (want == 0).any()   # lit, masked and blocked
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())


def test_fused_chunk_gradients_flow_through_plain_version():
    """On the CPU the wrapper is the plain version, so autograd reaches
    px and scal_f (the backward the kernel's autograd.Function reuses)."""
    u, px, scal_f = _chunk_inputs(0, 8, 64, 3, 1, 1)
    px_t = torch.from_numpy(px).requires_grad_(True)
    sc_t = torch.from_numpy(scal_f).requires_grad_(True)
    out = fused_shadow.fused_chunk(torch.from_numpy(u), px_t, sc_t, 8, lc=8,
                                   ns=3, npl=1, egid=1, phong=True,
                                   atten_kind="sqr")
    out.sum().backward()
    assert torch.isfinite(px_t.grad).all() and torch.isfinite(sc_t.grad).all()
    assert px_t.grad.abs().sum() > 0 and sc_t.grad[4:7].abs().sum() > 0


def _split_sum(u, px, scal_f, n_valid, slices, **kw):
    """Kernel 2's sum under its sample split, on the plain version: warp y
    of a block adds samples y, y + slices, ... of its pixels in order, and
    the warps' partial sums are added in warp order."""
    lc = kw["lc"]
    parts = []
    for y in range(slices):
        acc = torch.zeros(3, px.shape[1])
        for s in range(y, lc, slices):
            acc = acc + fused_shadow.fused_chunk_reference(
                u[:, s:s + 1].contiguous(), px, scal_f, int(s < n_valid),
                **dict(kw, lc=1))
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


@pytest.mark.parametrize("slices", [1, 4, 8, 16])
@pytest.mark.parametrize("lc,n_valid", [(40, 40), (16, 12)],
                         ids=["full", "tail"])
def test_fused_sample_split_matches_jax(slices, lc, n_valid):
    """Each sample lands in exactly one warp's partial sum, and the split
    sum agrees with the JAX chunk within the tolerance of the plain
    version's own test (rtol 1e-5, atol 1e-6·max): only the order of the
    additions differs.  Kernel 2 compiles 8 warps a block (``kSlices`` in
    ``csrc/fused_shadow.cu``); the other splits hold the order of the sum
    to that tolerance for any warp count the constant might take."""
    ns, npl, egid, P = 4, 2, 2, 1024
    kw = dict(lc=lc, ns=ns, npl=npl, egid=egid, phong=True, atten_kind="sqr")
    u, px, scal_f = _chunk_inputs(lc + n_valid, lc, P, ns, npl, egid)
    ref = jsh._packed_sphere_chunk_ref(True, lc, ns, npl, egid, "sqr")
    want = np.asarray(ref(jnp.asarray(u), jnp.asarray(px),
                          jnp.asarray(scal_f), jnp.asarray([n_valid])))
    t = torch.from_numpy
    got = _split_sum(t(u), t(px), t(scal_f), n_valid, slices, **kw).numpy()
    assert want.max() > 0 and (want == 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())

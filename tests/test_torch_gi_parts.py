"""The pieces of path-traced GI in the port: ``shading.sample_hemisphere``
against the JAX package's with the same uniforms, values and the gradient
with respect to the normal, and the integrator's skipping of GI samples
that no lane can take.

``sample_hemisphere``: unit normals from a NumPy seed, and four set by
hand: one pointing straight down (the 180° X-flip fires), one a hair above
-Y inside its hit object's epsilon (the flip fires through ``eps``), one
just outside it (no flip: the rotation's ``1/(1 + ny)`` is ~100, whose
gradient JAX leaves unguarded as the port does), and +Y.  Tolerances:
directions and cosines within 1e-6 (unit vectors; ``torch.arccos`` and
XLA's may round an ulp apart), the gradient within 1e-4 of its largest
entry.

Skipping: in a round with no primary lane, GI samples past the first (and
every sample of a chunk with a ``gi_sample_offset``) have no lane to run.
The port skips them except under union shadows, whose guard counts every
lane's list; the frame and the stats are bit-identical to running every
sample, here on the chain (dense stand-in), the dense stack
(scenes/example.json) and the cluster stack with per-ray shadows (the
glass soup of tests/test_torch_union_render.py cut to 128 triangles).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.core import v3 as jv3
from c_raytracer_tpu.render import shading as JS
from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.core import v3 as tv3
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, integrator
from c_raytracer_tpu_torch.render import make_renderer
from c_raytracer_tpu_torch.render import shading as TS
from c_raytracer_tpu_torch.scene import load_scene, make_scene
from test_torch_union_render import glass_soup_kwargs

pytest_plugins = ("torch_harness",)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


class FixedKey:
    """A port sample key whose one draw is ``u``."""

    def __init__(self, u):
        self.u = u

    def uniform(self, shape):
        assert tuple(shape) == self.u.shape
        return torch.from_numpy(self.u)


def _normals():
    """(normals (P, 3), eps (P,)): 60 random unit normals, then the four
    cases of the module docstring."""
    rng = np.random.default_rng(2)
    n = rng.normal(size=(60, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    tilt = np.sqrt(1 - (1 - 5e-4) ** 2)
    near = np.sqrt(1 - (1 - 1e-2) ** 2)
    n = np.concatenate([n, [[0, -1, 0], [tilt, -(1 - 5e-4), 0],
                            [near, -(1 - 1e-2), 0], [0, 1, 0]]])
    eps = rng.uniform(1e-4, 1e-2, len(n))
    eps[-4:] = [1e-3, 1e-3, 1e-3, 1e-3]
    return n.astype(np.float32), eps.astype(np.float32)


def test_sample_hemisphere_matches_jax():
    n, eps = _normals()
    P = len(n)
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(key, (2, P), jnp.float32))
    rng = np.random.default_rng(3)
    w = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    wc = rng.uniform(-1, 1, P).astype(np.float32)

    def jax_loss(nn):
        d, cos = JS.sample_hemisphere(key, jv3.from_aos(nn),
                                      jnp.asarray(eps))
        return jnp.sum(jv3.to_aos(d) * w) + jnp.sum(cos * wc), (d, cos)

    with jax.disable_jit():
        (_, (jd, jcos)), jg = jax.value_and_grad(jax_loss, has_aux=True)(
            jnp.asarray(n))
    nt = torch.from_numpy(n).requires_grad_(True)
    d, cos = TS.sample_hemisphere(FixedKey(u), tv3.from_aos(nt),
                                  torch.from_numpy(eps))
    (torch.sum(tv3.to_aos(d) * torch.from_numpy(w))
     + torch.sum(cos * torch.from_numpy(wc))).backward()

    jd = np.asarray(jv3.to_aos(jd))
    d = tv3.to_aos(d).detach().numpy()
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cos.detach().numpy(), np.asarray(jcos),
                               rtol=0, atol=1e-6)
    # the flip (lo.x, -lo.y, -lo.z) straight down and within eps of it,
    # not just outside it; every sample in the normal's hemisphere
    inc, azi = np.arccos(u[0] * 2 - 1), u[1] * np.float32(np.pi)
    lo = np.stack([np.cos(azi) * np.sin(inc), np.sin(azi) * np.sin(inc),
                   np.cos(inc)], -1)
    flip = lo * [1, -1, -1]
    np.testing.assert_allclose(d[-4:-2], flip[-4:-2], atol=1e-6)
    assert np.abs(d[-2] - flip[-2]).max() > 1e-2
    assert np.all(np.abs(np.linalg.norm(d, axis=1) - 1) < 1e-5)
    assert np.all(cos.detach().numpy() >= -1e-6)
    g, jg = nt.grad.numpy(), np.asarray(jg)
    assert np.all(np.isfinite(g)) and np.abs(jg).max() > 0
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * np.abs(jg).max())


def _with_lights(sc, n):
    return dataclasses.replace(sc, static=dataclasses.replace(
        sc.static, num_lights=tuple(n if k else 0
                                    for k in sc.static.num_lights)))


SKIP_CASES = {
    "chain_dense": ("spheres_opaque.json", dict(max_bounces=3)),
    "chain_dense_offset": ("spheres_opaque.json", dict(
        max_bounces=3, gi_sample_offset=2, gi_chunk_weight=2)),
    "stack_dense": ("example.json", dict(max_bounces=2)),
    "stack_cluster_per_ray": ("soup", dict(
        max_bounces=2, accel="cluster", shadow_mode="per_ray")),
}


@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_skipped_samples_change_nothing(case, monkeypatch):
    """Skipping GI samples that no lane takes gives the frame and stats of
    running every sample, bit for bit, and runs fewer samples."""
    name, kw = SKIP_CASES[case]
    if name == "soup":
        sc = reorder_scene(make_scene(**glass_soup_kwargs(nt=128)))
    else:
        sc = load_scene(os.path.join(SCENES, name))
    sc = _with_lights(sc, 8)
    cfg = RenderConfig(gi_model="path", samples_per_pixel=3, light_chunk=8,
                       **kw)
    runs = {}
    real = integrator._gi_sample

    def counted(*a):
        calls[0] += 1
        return real(*a)

    monkeypatch.setattr(integrator, "_gi_sample", counted)
    for skip in (True, False):
        calls = [0]
        if not skip:
            monkeypatch.setattr(integrator, "_may_skip", lambda ix: False)
        img, z, st = make_renderer(sc.static, cfg, 12, 12, device="cpu",
                                   with_stats=True)(
            sc.params, PhiloxSampler(5, "cpu"))
        runs[skip] = (img, z, {k: float(v) for k, v in st.items()}, calls[0])
    (img, z, st, n_skip), (img_all, z_all, st_all, n_all) = (runs[True],
                                                            runs[False])
    assert torch.equal(img, img_all) and torch.equal(z, z_all)
    assert st == st_all
    assert st["gi_rays"] > 0 and st["main_rays"] > 144
    assert 0 < n_skip < n_all


def test_union_shadows_run_every_sample(monkeypatch):
    """Under union shadows the guard counts every lane's list, so no GI
    sample is skipped."""
    sc = _with_lights(reorder_scene(make_scene(**glass_soup_kwargs(nt=128))),
                      8)
    cfg = RenderConfig(gi_model="path", samples_per_pixel=2, light_chunk=8,
                       max_bounces=1, accel="cluster")
    calls = []
    real = integrator._gi_path

    def counted(ix, *a):
        calls.append(integrator._may_skip(ix))
        return real(ix, *a)

    monkeypatch.setattr(integrator, "_gi_path", counted)
    make_renderer(sc.static, cfg, 8, 8, device="cpu")(
        sc.params, PhiloxSampler(1, "cpu"))
    assert calls and not any(calls)

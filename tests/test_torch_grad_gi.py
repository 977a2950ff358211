"""Gradients through path-traced GI: the port's ``make_renderer`` under
``loss.backward()`` against ``jax.grad`` of the JAX package's renderer run
op by op, with the loss, the injected JAX uniforms and the tolerances of
tests/test_torch_grad.py (every leaf within 1e-4 · max|g_jax|, remat on
equal to remat off bit for bit, no occlusion query in the backward), and
finite differences of the port alone.

Each GI sample is a rematerialised region inside its round's region, so a
fwd+bwd step shades each child three times (forward, the round's
recompute, the sample's recompute), as the JAX package does; the child
shade's occlusion masks are kept under the child's own sample path.

Cases: the dense stand-in (kernel 2's route at primary and child hits) at
12x12, 2 samples a pixel, 8 light samples, 2 bounces; the 128-triangle
glass soup of tests/test_torch_grad_stack.py (cluster stack, union
shadows) runs from tests/test_torch_grad_gi_mesh.py, so that each file
takes about a minute alone on the CPU.

Finite differences (the method of tests/test_torch_grad_fd.py): the dense
stand-in at 24x24 with 4 samples a pixel, 4 light samples and 2 bounces;
the emitter's ``ke`` reaches the loss through the direct light of primary
and child hits, and ``ks`` through the child shade's specular too.  The
Philox draws are a function of the sample path, so each probe perturbs
the same program.
"""

import dataclasses

import numpy as np
import pytest

from c_raytracer_tpu_torch.render import RenderConfig
from c_raytracer_tpu_torch.scene import load_scene, named_leaves
from test_torch_grad import check_grads
from test_torch_grad_fd import SCENE, _check, _setup

pytest_plugins = ("torch_harness",)

GI = dict(gi_model="path", samples_per_pixel=2)
CASES = {
    "gi_dense_stand_in": dict(scene="stand_in", lights=8, res=(12, 12),
                              kw=dict(GI, max_bounces=2, light_chunk=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax(case, monkeypatch):
    check_grads(case, monkeypatch, CASES)


@pytest.fixture(scope="module")
def gi_setup():
    sc = load_scene(SCENE)
    static = dataclasses.replace(
        sc.static, num_lights=tuple(min(n, 4) for n in sc.static.num_lights))
    cfg = RenderConfig(gi_model="path", samples_per_pixel=4, max_bounces=2)
    loss, g = _setup(static, sc.params, cfg, 3)
    return sc.params, loss, g


def test_gi_grads_finite(gi_setup):
    _, _, g = gi_setup
    for name, leaf in named_leaves(g):
        assert np.all(np.isfinite(leaf)), name


@pytest.mark.parametrize("path,idx,eps,rtol,min_mag", [
    ("materials.ke", (3, 1), 1e-3, 0.1, 1e-4),   # the emitter's ke
    ("materials.ks", (0, 2), 1e-3, 0.1, 1e-4),   # the red sphere's ks
    ("materials.ks", (2, 0), 1e-3, 0.1, 1e-4),   # the plane's ks
])
def test_gi_fd(gi_setup, path, idx, eps, rtol, min_mag):
    _check(gi_setup, path, idx, eps, rtol, min_mag)

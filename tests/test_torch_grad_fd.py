"""Finite-difference gates of the port's gradients, the port alone, on
in-repo scenes: ``loss.backward()`` through the port's ``make_renderer``
against central differences of the same loss, by the method of
tests/test_grad.py (``fd``, ``check_component``; the JAX package's gates
need the reference scenes, which are not in the repo).

The renderer is a deterministic function of (params, sampler), so with a
fixed Philox seed the probe perturbs the same program.  Hit/miss and
occlusion boundaries make the image only a.e.-differentiable, so the loss
is a smooth weighted sum over all pixels, and each check is gated by a
relative tolerance and by ``min_mag``, the float32 FD noise floor, as in
tests/test_grad.py.  The probe's loss is summed in float64 (the image stays
float32).

Scenes: the dense stand-in (scenes/spheres_opaque.json, kernel 2's route)
at 24² with 4 light samples and 3 bounces; the bumpy mesh of
tests/test_torch_grad.py through the cluster route; the glass sphere over a
lit plane of tests/test_grad_mesh_refract.py through the stack integrator,
whose ``refractive_index`` reaches the loss only through the Snell rotation
and whose ``kt`` through the carried throughput and the shadow tint.  Its
probes take that file's steps and gates.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import (grads_to_numpy, load_scene,
                                         make_scene, named_leaves,
                                         params_to_torch)
from test_grad import _set, check_component
from test_grad_mesh_refract import _glass_sphere_scene
from test_torch_grad import bumpy_kwargs

SCENE = os.path.join(os.path.dirname(__file__), "..", "scenes",
                     "spheres_opaque.json")
RES = 24


def _setup(static, params, cfg, seed):
    """(loss of NumPy params -> float, analytic grads of that loss)."""
    fn = make_renderer(static, cfg, RES, RES, device="cpu")
    w = np.random.default_rng(seed).uniform(size=(RES, RES, 3))

    def loss(p):
        img, _ = fn(p, PhiloxSampler(seed, "cpu"))
        return float((img.double() * torch.from_numpy(w)).sum())

    p = params_to_torch(params, "cpu")
    for _, x in named_leaves(p):
        x.requires_grad_(True)
    img, _ = fn(p, PhiloxSampler(seed, "cpu"))
    (img * torch.from_numpy(w).float()).sum().backward()
    return loss, grads_to_numpy(p)


@pytest.fixture(scope="module")
def dense_setup():
    sc = load_scene(SCENE)
    static = dataclasses.replace(
        sc.static, num_lights=tuple(min(n, 4) for n in sc.static.num_lights))
    loss, g = _setup(static, sc.params, RenderConfig(max_bounces=3), 3)
    return sc.params, loss, g


@pytest.fixture(scope="module")
def mesh_setup():
    sc = make_scene(**bumpy_kwargs())
    cfg = RenderConfig(max_bounces=2, accel="cluster", light_chunk=8)
    loss, g = _setup(sc.static, sc.params, cfg, 5)
    return sc.params, loss, g


def glass_sphere_kwargs():
    """make_scene arguments of tests/test_grad_mesh_refract.py's glass
    sphere scene."""
    return dict(
        sphere_center=[[0.0, 0.0, 0.0], [1.5, 3.0, -2.0]],
        sphere_radius=[1.0, 0.4],
        sphere_material=[0, 2], sphere_lights=[0, 4],
        plane_point=[[0, -2.0, 0]], plane_normal=[[0, 1, 0]],
        plane_material=[1],
        materials=[
            dict(ks=[0.3, 0.3, 0.3], kt=[0.9, 0.85, 0.8], shininess=5.0,
                 refractive_index=1.5, tex_color=[0, 0, 0]),
            dict(ks=[0.2, 0.2, 0.2], ka=[0.4, 0.4, 0.4], shininess=2.0,
                 tex_color=[0.8, 0.85, 0.9]),
            dict(ke=[25.0, 25.0, 25.0], tex_color=[1, 1, 1]),
        ],
        camera=dict(position=[0.0, 0.3, -4.0], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0.08], fov=55, focal_length=1),
        ambient=(0.2, 0.2, 0.2))


@pytest.fixture(scope="module")
def glass_setup():
    sc = make_scene(**glass_sphere_kwargs())
    ref = _glass_sphere_scene()
    assert dataclasses.asdict(sc.static) == dataclasses.asdict(ref.static)
    cfg = RenderConfig(max_bounces=4, rounds=8, light_chunk=8)
    loss, g = _setup(sc.static, sc.params, cfg, 7)
    return sc.params, loss, g


def _leaf_access(path, idx):
    """(getter, setter) of element ``idx`` of the leaf at ``path``
    ("sphere_radius", "materials.ka", "camera.fov", ...)."""
    sub, _, name = path.rpartition(".")

    def getter(tree):
        leaf = getattr(getattr(tree, sub) if sub else tree, name)
        return leaf if idx is None else leaf[idx]

    def setter(tree, v):
        obj = getattr(tree, sub) if sub else tree
        old = getattr(obj, name)
        new = np.float32(v) if idx is None else _set(old, idx, v)
        obj = dataclasses.replace(obj, **{name: new})
        return dataclasses.replace(tree, **{sub: obj}) if sub else obj

    return getter, setter


def test_dense_grads_finite_and_live(dense_setup):
    _, _, g = dense_setup
    for name, leaf in named_leaves(g):
        assert np.all(np.isfinite(leaf)), name
    for name in ("sphere_center", "sphere_radius", "plane_d",
                 "materials.ka", "materials.ke", "materials.ks",
                 "materials.kr", "materials.tex_color", "camera.position",
                 "camera.fov"):
        assert np.abs(dict(named_leaves(g))[name]).max() > 1e-3, name


@pytest.mark.parametrize("path,idx,eps,rtol,min_mag", [
    # eps per component from sweeps over 1e-3 .. 3e-6 on the CPU: steps
    # from 3e-4 up move a silhouette or one of the 4-sample shadow edges
    # for the mirror sphere and the camera (FD reads -26 where the slope
    # is -0.15), steps from 3e-5 down sink into float32 noise (~5e-3 at
    # 1e-4, so min_mag 1e-2 there); plane_d is clean at 1e-3 but crosses
    # a shadow edge at 2e-3
    ("sphere_center", (1, 0), 1e-4, 0.2, 1e-2),   # mirror sphere x
    ("sphere_center", (1, 1), 1e-4, 0.2, 1e-2),   # mirror sphere y
    ("sphere_radius", 0, 2.5e-4, 0.2, 1e-3),      # red sphere
    ("plane_d", 0, 1e-3, 0.2, 1e-3),
    # materials: red ka, the emitter's ke, red ks, the mirror's kr, red's
    # texture colour (linear in the loss but for the occlusion masks)
    ("materials.ka", (0, 0), 1e-3, 0.1, 1e-4),
    ("materials.ke", (3, 1), 1e-3, 0.1, 1e-4),
    ("materials.ks", (0, 2), 1e-3, 0.1, 1e-4),
    ("materials.kr", (1, 0), 1e-3, 0.1, 1e-4),
    ("materials.tex_color", (0, 1), 1e-3, 0.1, 1e-4),
    # camera moves shift silhouettes: a looser gate, as in test_grad.py
    ("camera.position", 1, 1e-4, 0.3, 1e-2),
    ("camera.fov", None, 2e-3, 0.3, 1e-3),
])
def test_dense_fd(dense_setup, path, idx, eps, rtol, min_mag):
    _check(dense_setup, path, idx, eps, rtol, min_mag)


@pytest.mark.parametrize("ti,vi,ci", [(72, 0, 1), (56, 0, 1)])
def test_mesh_vertex_fd(mesh_setup, ti, vi, ci):
    """A height-field vertex's y through the cluster route: hit distance,
    derived normal, shading and shadows move together.  The mesh frame's
    loss is small: the probed slopes are ~4e-4 and FD met them within 3e-6
    at this step on the CPU, hence the low floor."""
    _check(mesh_setup, "tri_vertices", (ti, vi, ci), 2.5e-4, 0.25, 2e-5)


def test_glass_grads_finite_and_live(glass_setup):
    """The refraction chain is live: without a refraction push the ior
    gradient would be 0."""
    _, _, g = glass_setup
    for name, leaf in named_leaves(g):
        assert np.all(np.isfinite(leaf)), name
    assert abs(float(g.materials.refractive_index[0])) > 1e-3
    assert np.abs(g.materials.kt[0]).min() > 1e-3


@pytest.mark.parametrize("path,idx,eps,rtol", [
    # TIR boundaries at the sphere's limb flip under perturbation; the
    # refraction inside dominates the weighted loss
    ("materials.refractive_index", 0, 1e-3, 0.25),
    ("materials.kt", (0, 0), 1e-3, 0.15),
    ("materials.kt", (0, 1), 1e-3, 0.15),
    ("materials.kt", (0, 2), 1e-3, 0.15),
])
def test_glass_fd(glass_setup, path, idx, eps, rtol):
    _check(glass_setup, path, idx, eps, rtol, 1e-3)


def _check(setup, path, idx, eps, rtol, min_mag):
    """check_component, which must not pass for a probe below the noise
    floor."""
    params, loss, g = setup
    getter, setter = _leaf_access(path, idx)
    assert abs(float(getter(g))) > min_mag, f"{path}{idx} below the floor"
    check_component(loss, params, g, getter, setter, eps=eps, rtol=rtol,
                    min_mag=min_mag)

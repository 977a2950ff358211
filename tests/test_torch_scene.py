"""The port's NumPy scene loader, make_scene and the weights bridge against
the JAX package's (exact: both are the same host NumPy code)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from c_raytracer_tpu.scene import load_scene as jax_load_scene
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.scene import load_scene, make_scene, params_to_torch
from c_raytracer_tpu_torch.scene.loader import SceneError

pytest_plugins = ("torch_harness",)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _leaves(params):
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _leaves(v).items()})
        else:
            out[f.name] = v
    return out


def _assert_same(port, ref):
    assert dataclasses.asdict(port.static) == dataclasses.asdict(ref.static)
    a, b = _leaves(port.params), _leaves(ref.params)
    assert a.keys() == b.keys()
    for k in a:
        x = a[k].detach().cpu().numpy() if isinstance(a[k], torch.Tensor) \
            else np.asarray(a[k])
        assert x.dtype == np.float32, k
        np.testing.assert_array_equal(x, np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("name", ["spheres_opaque.json", "example.json"])
def test_loader_matches_jax(name):
    path = os.path.join(SCENES, name)
    _assert_same(load_scene(path), jax_load_scene(path))


def test_stand_in_scene_is_dense_opaque():
    st = load_scene(os.path.join(SCENES, "spheres_opaque.json")).static
    assert st.n_triangles == 0 and not any(st.is_transparent)
    assert st.emitter_prims == (3,) and st.num_lights[3] == 200


@pytest.mark.parametrize("scale", [0.5, "norm"])
def test_loader_scale_matches_jax(scale):
    path = os.path.join(SCENES, "example.json")
    _assert_same(load_scene(path, scale=scale),
                 jax_load_scene(path, scale=scale))


def _fixture_kwargs(seed):
    r = np.random.default_rng(seed)
    mats = [dict(ks=r.random(3), ka=r.random(3), kr=r.random(3), kt=[0] * 3,
                 ke=[0] * 3, shininess=float(r.integers(1, 64)),
                 refractive_index=1.0, tex_type=1, tex_color=r.random(3),
                 tex_color2=r.random(3), tex_scale=2.0),
            dict(ke=[4, 4, 3], tex_type=0, tex_color=[1, 1, 1])]
    cam = dict(position=r.normal(size=3), vector_x=[1, 0.1, 0],
               vector_y=[0, 1, 0.2], fov=50, focal_length=1.5)
    return dict(
        sphere_center=r.normal(size=(3, 3)), sphere_radius=r.random(3) + 0.2,
        sphere_material=[0, 0, 1], sphere_lights=[0, 0, 16],
        sphere_epsilon=[-1.0, 0.01, -1.0],
        tri_vertices=r.normal(size=(2, 3, 3)), tri_material=[0, 0],
        plane_point=r.normal(size=(2, 3)), plane_normal=r.normal(size=(2, 3)),
        plane_material=[0, 0], materials=mats, camera=cam,
        ambient=(0.1, 0.2, 0.3))


@pytest.mark.parametrize("seed", [0, 1])
def test_make_scene_matches_jax(seed):
    kw = _fixture_kwargs(seed)
    _assert_same(make_scene(**kw), jax_make_scene(**kw))


def test_make_scene_rejects_bad_fov():
    kw = _fixture_kwargs(0)
    kw["camera"] = dict(kw["camera"], fov=180)
    with pytest.raises(ValueError, match="fov"):
        make_scene(**kw)


def test_loader_error_wording(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"Materials": [], "Objects": [], "Camera": {}}')
    with pytest.raises(SceneError, match="Expected token \\[Camera\\] to "
                                         "contain 5 elements."):
        load_scene(str(bad))


@pytest.mark.parametrize("source", ["jax", "port", "jax_mesh_reordered"])
def test_params_to_torch(source):
    if source == "jax_mesh_reordered":
        # the JAX package's Morton-ordered params of the mesh stand-in
        from c_raytracer_tpu.accel import reorder_scene as jax_reorder
        path = os.path.join(SCENES, "meshes_opaque.json")
        sc = jax_reorder(jax_load_scene(path))
        ref = sc
    else:
        path = os.path.join(SCENES, "example.json")
        sc = jax_load_scene(path) if source == "jax" else load_scene(path)
        ref = jax_load_scene(path)
    tp = params_to_torch(sc.params, "cpu")
    _assert_same(dataclasses.replace(ref, params=tp), ref)
    for v in _leaves(tp).values():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
    # tensors pass through unchanged
    again = params_to_torch(tp, "cpu")
    assert again.sphere_center.data_ptr() == tp.sphere_center.data_ptr()

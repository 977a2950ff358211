"""The flagship tool (c_raytracer_tpu_torch/tools/flagship_s5.py) against
the JAX package's composition of the same calls.

The JAX tool itself loads scene5 from a reference checkout that is not in
the repository, so the test composes its calls from the JAX package, with
the JAX draws injected (``JaxKeySampler``) and JAX run op by op
(``jax.disable_jit``, ``remat=False``):

* the forward phase on the glass soup of tests/test_torch_union_render.py
  (600 glass triangles in Morton clusters, union shadows, the emitter
  capped at 2 light samples), the tool's config cut to 1 bounce, at 8x8
  with 2 path-GI samples in 2 chunks, against JAX's
  ``render_spp_chunked(host_tiled=True)``: ray counts and spill maxima
  equal, z within rtol 1e-6, the image within the refraction tolerances
  of the port's stack tests (1e-3 · max everywhere, 1e-5 · max on 99% of
  the pixels);
* two steps of the train phase at the tool's step, its config cut to 2
  samples and 2 bounces (at 1 a ray that enters the glass never leaves it,
  and kt moves nothing), against a JAX loop of the same update through
  ``make_host_tiled_value_and_grad``: each loss within rtol 1e-5 and the
  glass kt within 1e-6 after each step (the batches' gradients sum in
  another order); the loss falls.  It runs on a glass sphere before an
  opaque one (``glass_spheres``): JAX's value-and-grad of the cluster
  route takes over a minute a step op by op;
* the glass material the tool picks on the stand-in
  (scenes/meshes_glass.json: id 5, index 3);
* the tool's ``main`` on the CPU at 4x4 on the same glass sphere in a
  scene file: its two JSON lines carry the JAX tool's keys, and the loss
  falls at the tool's step; with ``--forward-only`` it prints the forward
  line alone.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import make_host_tiled_renderer as jax_tiled
from c_raytracer_tpu.render import make_host_tiled_value_and_grad as jax_vg
from c_raytracer_tpu.render import render_spp_chunked as jax_spp_chunked
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.scene import load_scene, make_scene
from c_raytracer_tpu_torch.tools import flagship_s5 as fs
from test_torch_render import JaxKeySampler
from test_torch_union_render import glass_soup

pytest_plugins = ("torch_harness",)

RES, SPP, CHUNKS, LIGHTS = 8, 2, 2, 2
TRAIN_RES, STEPS = 8, 2
SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
FORWARD_KEYS = {"phase", "res", "spp", "lights", "spp_chunks", "seconds",
                "total_radiance", "mean_radiance", "shadow_spill_max",
                "visit_spill_max", "total_rays"}
TRAIN_KEYS = {"phase", "res", "spp", "steps", "seconds", "losses",
              "kt_start", "kt_target", "kt_end", "loss_reduced"}


@functools.lru_cache(maxsize=None)
def _scenes():
    jsc, psc = glass_soup()
    return fs.cap_lights(jsc, LIGHTS), fs.cap_lights(psc, LIGHTS)


GLASS = dict(ks=[0.3] * 3, ka=[0.05] * 3, kr=[0.05] * 3,
             kt=[0.85, 0.85, 0.9], shininess=200, refractive_index=1.5,
             tex_color=[0.95, 0.95, 1.0])
RED = dict(ks=[0.9] * 3, ka=[0.4, 0.1, 0.1], shininess=32,
           tex_color=[0.85, 0.25, 0.2])
LAMP = dict(ke=[30, 30, 27], tex_color=[1, 1, 1])


def glass_spheres_kwargs():
    """A glass sphere filling most of the frame before an opaque one, and
    an emitter of 8 light samples above."""
    return dict(
        sphere_center=[[0, 0, 0], [0.3, 0, 4], [0, 5, -2]],
        sphere_radius=[1.6, 2.0, 1.0], sphere_material=[0, 1, 2],
        sphere_lights=[0, 0, 8], materials=[GLASS, RED, LAMP],
        camera=dict(position=[0, 0, -4], vector_x=[1, 0, 0],
                    vector_y=[0, 1, 0], fov=55, focal_length=1))


def _scene_file(path):
    """``glass_spheres_kwargs`` in the reference's JSON scene format."""
    kw = glass_spheres_kwargs()

    def material(i, m):
        return {"id": i + 1, "ks": m.get("ks", [0] * 3),
                "ka": m.get("ka", [0] * 3), "kr": m.get("kr", [0] * 3),
                "kt": m.get("kt", [0] * 3), "ke": m.get("ke", [0] * 3),
                "shininess": m.get("shininess", 1),
                "refractive_index": m.get("refractive_index", 1),
                "texture": {"type": "uniform", "color": m["tex_color"]}}

    objects = [{"type": "Sphere", "parameters": dict(
        material=mat + 1, position=c, radius=r,
        **({"lights": n} if n else {}))}
        for c, r, mat, n in zip(kw["sphere_center"], kw["sphere_radius"],
                                kw["sphere_material"], kw["sphere_lights"])]
    path.write_text(json.dumps({
        "AmbientLight": [0.15, 0.15, 0.18], "Camera": kw["camera"],
        "Materials": [material(i, m) for i, m in
                      enumerate(kw["materials"])],
        "Objects": objects}))
    return str(path)


def _jax_config(cfg):
    return JaxConfig(**{**dataclasses.asdict(cfg), "remat": False})


def test_forward_matches_jax():
    jsc, psc = _scenes()
    cfg = dataclasses.replace(fs.forward_config(SPP), max_bounces=1)
    key = jax.random.PRNGKey(0)
    with jax.disable_jit():
        j_img, j_z, j_st = jax_spp_chunked(
            jsc, _jax_config(cfg), RES, RES, key, spp_chunks=CHUNKS,
            host_tiled=True, with_stats=True)
    img, z, st, secs = fs.forward(psc, cfg, RES, CHUNKS,
                                  JaxKeySampler(key, 1), device="cpu")
    assert img.shape == j_img.shape == (RES, RES, 3)
    assert st == {k: float(v) for k, v in j_st.items()}
    assert st["gi_rays"] > 0 and st["children_pushed"] > 0
    np.testing.assert_array_equal(z == 0, j_z == 0)
    np.testing.assert_allclose(z, j_z, rtol=1e-6, atol=0)
    assert np.all(np.isfinite(img)) and j_img.max() > 0
    diff = np.abs(img - j_img).max(-1)
    assert diff.max() <= 1e-3 * j_img.max()
    assert (diff <= 1e-5 * j_img.max()).mean() >= 0.99
    line = fs.forward_line(img, st, secs, RES, SPP, LIGHTS, CHUNKS)
    assert set(line) == FORWARD_KEYS
    assert line["total_rays"] == (j_st["main_rays"] + j_st["shadow_rays"]
                                  + j_st["gi_rays"])


def _jax_train(jsc, cfg, key):
    """The JAX tool's phase 2 (tools/flagship_s5.py:95-128) at STEPS
    steps of the port tool's step; returns (losses, glass kt after each
    step)."""
    g = fs.glass_material(jsc.params)
    kt_t = np.asarray(jsc.params.materials.kt).copy()
    kt_t[g] = fs.KT_TARGET
    target_params = dataclasses.replace(
        jsc.params, materials=dataclasses.replace(
            jsc.params.materials, kt=jnp.asarray(kt_t)))

    def pixel_loss(color, z, tgt):
        return jnp.sum((color - tgt) ** 2, axis=-1)

    with jax.disable_jit():
        target = np.asarray(jax_tiled(jsc.static, cfg, TRAIN_RES, TRAIN_RES)(
            target_params, key)[0]).reshape(-1, 3)
        vg = jax_vg(jsc.static, cfg, TRAIN_RES, TRAIN_RES, pixel_loss)
        params, losses, kts = jsc.params, [], []
        for _ in range(STEPS):
            loss, grads = vg(params, key, target=jnp.asarray(target))
            losses.append(float(loss))
            params = dataclasses.replace(params, materials=dataclasses.replace(
                params.materials,
                kt=params.materials.kt - fs.TRAIN_LR * grads.materials.kt))
            kts.append(np.asarray(params.materials.kt)[g])
    return losses, kts


def test_train_steps_match_jax():
    kw = glass_spheres_kwargs()
    jsc, psc = jax_make_scene(**kw), make_scene(**kw)
    cfg = dataclasses.replace(fs.train_config(), samples_per_pixel=2,
                              max_bounces=2)
    key = jax.random.PRNGKey(1)
    j_losses, j_kts = _jax_train(jsc, _jax_config(cfg), key)
    out = fs.train(psc, cfg, TRAIN_RES, JaxKeySampler(key, 1), device="cpu",
                   steps=STEPS)
    kts = [kt.numpy() for kt in out["kts"]]
    assert out["glass"] == 0
    np.testing.assert_allclose(out["losses"], j_losses, rtol=1e-5)
    np.testing.assert_allclose(kts, j_kts, rtol=0, atol=1e-6)
    assert out["losses"][-1] < out["losses"][0]
    assert not np.allclose(kts[-1], out["kt_start"].numpy())
    line = fs.train_line(out, TRAIN_RES, cfg.samples_per_pixel)
    assert set(line) == TRAIN_KEYS and line["loss_reduced"]


def test_glass_material_of_the_stand_in():
    sc = load_scene(os.path.join(SCENES, "meshes_glass.json"))
    g = fs.glass_material(sc.params)
    assert g == 3
    np.testing.assert_array_equal(
        np.asarray(sc.params.materials.kt)[g],
        np.float32([0.85, 0.85, 0.9]))
    kt = np.asarray(sc.params.materials.kt).copy()
    kt[g] = 0
    with pytest.raises(ValueError, match="no transparent material"):
        fs.glass_material(dataclasses.replace(
            sc.params, materials=dataclasses.replace(sc.params.materials,
                                                     kt=kt)))


def test_main_on_the_cpu(capsys, tmp_path):
    assert fs.main(["4", "2", "2", "4", "2", "--device", "cpu", "--scene",
                    _scene_file(tmp_path / "glass.json")]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [ln["phase"] for ln in lines] == ["forward", "train"]
    assert set(lines[0]) == FORWARD_KEYS and set(lines[1]) == TRAIN_KEYS
    assert lines[0]["spp_chunks"] == 2 and lines[1]["steps"] == 6
    assert np.isfinite(lines[0]["total_radiance"])
    assert lines[1]["loss_reduced"]


def test_main_forward_only(capsys, tmp_path):
    assert fs.main(["4", "2", "2", "4", "2", "--device", "cpu", "--scene",
                    _scene_file(tmp_path / "glass.json"),
                    "--forward-only"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [ln["phase"] for ln in lines] == ["forward"]
    assert set(lines[0]) == FORWARD_KEYS
    assert (lines[0]["res"], lines[0]["spp"], lines[0]["spp_chunks"]) == (
        4, 2, 2)
    assert np.isfinite(lines[0]["total_radiance"])
    assert lines[0]["total_rays"] > 0

"""Progressive and spp-chunked renders (c_raytracer_tpu_torch/render/
progressive.py) against the JAX package's.

* ``render_progressive`` with JAX's chunk keys injected (``JaxChunkSampler``:
  chunk ``c`` draws JAX's uniforms under ``fold_in(key, c)``) against JAX's
  ``render_progressive`` run op by op (``jax.disable_jit``,
  ``remat=False``): the dense stand-in (scenes/spheres_opaque.json, lights
  capped at 8) at 16x16 in 3 chunks, every pixel within 1e-5 · max and z
  within rtol 1e-6; the glass soup of tests/test_torch_union_render.py at
  16x16 in 2 chunks, under that file's refraction tolerances (1e-3 · max
  everywhere, 1e-5 · max on 99% of the pixels).
* Resume: a 4-chunk render stopped after 2 with a checkpoint, then
  resumed, against the uninterrupted render: within a relative 1e-6 per
  pixel (the resumed sum restarts from the float32 mean in the raw TIFF,
  whose rounding is ~6e-8 of the pixel); an incompatible sidecar is
  ignored, and the fresh render it starts is bit-equal to one without a
  checkpoint.
* ``render_spp_chunked`` against the single call at the full
  ``samples_per_pixel``, within rtol 1e-4 / atol 1e-6 (float summation
  order), on the chain (dense stand-in) and the stack (glass soup), host
  tiled and not; indivisible spp is rejected.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import render_progressive as jax_progressive
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import (RenderConfig, make_renderer,
                                          render_progressive,
                                          render_spp_chunked)
from c_raytracer_tpu_torch.scene import load_scene
from test_torch_render import SCENE, JaxKeySampler, _stand_in
from test_torch_union_render import glass_soup


class _Scene:
    def __init__(self, static, params):
        self.static, self.params = static, params


class JaxChunkSampler:
    """A progressive render's base sampler whose chunk ``c`` draws the JAX
    renderer's uniforms under ``fold_in(key, c)``; its ``seed`` is what
    the JAX sidecar records, ``key_data(key)[-1]``."""

    def __init__(self, key, n_tiles):
        self.key, self.n_tiles = key, n_tiles
        self.seed = int(jax.random.key_data(key)[-1])

    def fold_in(self, c):
        return JaxKeySampler(jax.random.fold_in(self.key, c), self.n_tiles)


def _dense():
    static, params = _stand_in(lights=8)
    return _Scene(static, params)


def _port_dense():
    sc = load_scene(SCENE)
    return _Scene(dataclasses.replace(sc.static, num_lights=tuple(
        8 if n else 0 for n in sc.static.num_lights)), sc.params)


@pytest.mark.parametrize("scene", ["dense", "glass_soup"])
def test_matches_jax_progressive(scene):
    if scene == "dense":
        jsc = psc = _dense()
        kw, chunks, seed = dict(max_bounces=2), 3, 7
    else:
        jsc, psc = glass_soup()
        kw, chunks, seed = dict(max_bounces=1, light_chunk=8), 2, 11
    key = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        j_img, j_z = jax_progressive(jsc, JaxConfig(remat=False, **kw), 16,
                                     16, key, chunks=chunks)
    img, z = render_progressive(psc, RenderConfig(**kw), 16, 16,
                                JaxChunkSampler(key, 1), device="cpu",
                                chunks=chunks)
    assert img.dtype == z.dtype == np.float32
    assert img.shape == j_img.shape == (16, 16, 3) and z.shape == (16, 16)
    np.testing.assert_array_equal(z == 0, j_z == 0)
    np.testing.assert_allclose(z, j_z, rtol=1e-6, atol=0)
    assert np.all(np.isfinite(img)) and j_img.max() > 0
    diff = np.abs(img - j_img).max(-1)
    if scene == "dense":
        assert diff.max() <= 1e-5 * j_img.max()
    else:
        assert diff.max() <= 1e-3 * j_img.max()
        assert (diff <= 1e-5 * j_img.max()).mean() >= 0.99


def test_mean_of_chunk_renders():
    """The result is the float64 mean of the chunks' renders, chunk ``c``
    under ``sampler.fold_in(c)``; z is the first chunk's."""
    sc = _port_dense()
    cfg = RenderConfig(max_bounces=2)
    sampler = PhiloxSampler(4, "cpu")
    img, z = render_progressive(sc, cfg, 12, 10, sampler, device="cpu",
                                chunks=3)
    fn = make_renderer(sc.static, cfg, 12, 10, device="cpu")
    frames = [fn(sc.params, sampler.fold_in(c)) for c in range(3)]
    want = np.mean([f[0].numpy().astype(np.float64) for f in frames], 0)
    np.testing.assert_array_equal(img, want.astype(np.float32))
    np.testing.assert_array_equal(z, frames[0][1].numpy())
    assert not np.array_equal(frames[0][0].numpy(), frames[1][0].numpy())


def test_resume_after_interruption(tmp_path):
    sc = _port_dense()
    cfg = RenderConfig(max_bounces=2)
    ck = str(tmp_path / "ckpt.tif")
    full, full_z = render_progressive(sc, cfg, 16, 16,
                                      PhiloxSampler(3, "cpu"), device="cpu",
                                      chunks=4)
    logs = []
    render_progressive(sc, cfg, 16, 16, PhiloxSampler(3, "cpu"),
                       device="cpu", chunks=4, checkpoint=ck, resume=False,
                       _stop_after=2)
    with open(ck + ".progress.json") as f:
        assert json.load(f) == {"chunks": 4, "resx": 16, "resy": 16,
                                "base_seed": 3, "done": 2}
    resumed, z = render_progressive(
        sc, cfg, 16, 16, PhiloxSampler(3, "cpu"), device="cpu", chunks=4,
        checkpoint=ck, resume=True, log=lambda m, *a: logs.append(m % a))
    assert logs[0] == "Resuming progressive render at chunk 2/4."
    assert logs[-1] == "Progressive chunk 4/4 done."
    assert full.max() > 0 and np.all(full >= 0)
    # relative 1e-6 per pixel: the float32 mean's rounding
    assert np.all(np.abs(resumed - full) <= 1e-6 * np.abs(full))
    np.testing.assert_array_equal(z, full_z)
    with open(ck + ".progress.json") as f:
        assert json.load(f)["done"] == 4


def test_incompatible_checkpoint_ignored(tmp_path):
    sc = _port_dense()
    cfg = RenderConfig(max_bounces=2)
    ck = str(tmp_path / "ckpt.tif")
    render_progressive(sc, cfg, 16, 16, PhiloxSampler(1, "cpu"),
                       device="cpu", chunks=2, checkpoint=ck)
    logs = []
    fresh, fz = render_progressive(
        sc, cfg, 16, 16, PhiloxSampler(2, "cpu"), device="cpu", chunks=2,
        checkpoint=ck, log=lambda m, *a: logs.append(m % a))
    plain, pz = render_progressive(sc, cfg, 16, 16, PhiloxSampler(2, "cpu"),
                                   device="cpu", chunks=2)
    assert not any("Resuming" in m for m in logs)
    np.testing.assert_array_equal(fresh, plain)
    np.testing.assert_array_equal(fz, pz)


def _spp_scene(kind):
    if kind == "chain":
        return _port_dense(), RenderConfig(
            max_bounces=3, light_chunk=8, gi_model="path",
            samples_per_pixel=4)
    _, sc = glass_soup()
    return sc, RenderConfig(max_bounces=1, light_chunk=8, gi_model="path",
                            samples_per_pixel=4)


@pytest.mark.parametrize("kind", ["chain", "stack"])
def test_spp_chunked_equals_single_call(kind):
    sc, cfg = _spp_scene(kind)
    single, sz, sst = make_renderer(sc.static, cfg, 16, 16, device="cpu",
                                    with_stats=True)(
        sc.params, PhiloxSampler(5, "cpu"))
    for host_tiled in (True, False):
        img, z, st = render_spp_chunked(
            sc, cfg, 16, 16, PhiloxSampler(5, "cpu"), device="cpu",
            spp_chunks=2, host_tiled=host_tiled, with_stats=True)
        torch.testing.assert_close(torch.from_numpy(img), single,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(z, sz.numpy())
        assert st["gi_rays"] > 0 and sst["gi_rays"] > 0
        for k in ("shadow_spill_max", "visit_spill_max"):
            assert st[k] == float(sst[k])
    img1, _ = render_spp_chunked(sc, cfg, 16, 16, PhiloxSampler(5, "cpu"),
                                 device="cpu", spp_chunks=1)
    np.testing.assert_array_equal(img1, single.numpy())


def test_indivisible_spp_rejected():
    sc, cfg = _spp_scene("chain")
    with pytest.raises(ValueError, match="not divisible"):
        render_spp_chunked(sc, dataclasses.replace(cfg, samples_per_pixel=5),
                           8, 8, device="cpu", spp_chunks=2)

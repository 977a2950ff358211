"""Path-traced GI frames: the port's ``make_renderer`` under
``gi_model="path"`` against the JAX package's, with the JAX uniforms
injected (``JaxKeySampler`` of tests/test_torch_render.py replays the GI
key chain too), and the spp-chunk composition in the port alone.

Against JAX (run op by op, ``jax.disable_jit`` and ``remat=False``):
every ray count, the drops and both spill maxima exact; z with the same
zero pattern and rtol 1e-6 (z comes from primary hits only); the image
within 1e-5 · its max at every pixel.  Cases:

* the dense stand-in (scenes/spheres_opaque.json; the chain, kernel 2's
  route at the GI child hits) at 16x12 in two tiles of 128 pixels, the
  second padded, 3 samples a pixel, 12 light samples, 3 bounces;
* the same frame as the second of two spp chunks: ``gi_sample_offset=2``,
  ``gi_chunk_weight=2`` (its primary lanes only run GI);
* scenes/example.json at 16x16, 2 samples (the dense stack: a glass
  sphere, refraction children, GI at secondary hits);
* the glass soup of tests/test_torch_union_render.py at 16x16, 2 samples
  (the cluster stack with union shadows), run from
  tests/test_torch_gi_mesh.py so that each file takes about a minute alone.
  ``compare_frames`` allows 1% of a glass frame's pixels past 1e-5 · max
  (arcsin, arccos, sin and cos round differently in XLA and in torch);
  this frame needs none of it.

The spp-chunk identity (the JAX package's ``render_spp_chunked`` contract,
tests/test_progressive.py:83-101), through the port's
``render_spp_chunked``: a frame at 4 samples a pixel equals the
mean of two frames at 2 samples with offsets 0 and 2 and chunk weight 2,
within rtol 1e-4 and atol 1e-6, on the dense stand-in (chain) and on the
transparent lit soup of tests/test_parallel.py (cluster stack, union
shadows), with the port's Philox draws.
"""

import dataclasses
import os

import pytest
import torch

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.scene import load_scene as jax_load_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import (RenderConfig, make_renderer,
                                          render_spp_chunked)
from c_raytracer_tpu_torch.scene import load_scene
from test_parallel import _lit_soup
from test_torch_render import _stand_in
from test_torch_union_render import compare_frames

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "scenes",
                       "example.json")
GI = dict(gi_model="path")


class _Scene:
    """(static, params) as a scene bundle for ``compare_frames``."""

    def __init__(self, static, params):
        self.static, self.params = static, params


def check_exact(jax_scene, scene, kw, res, seed):
    """``compare_frames`` with every pixel within 1e-5 · max."""
    st = compare_frames(jax_scene, scene, kw, res, seed, share=1.0)
    assert st["gi_rays"] > 0
    return st


@pytest.mark.parametrize("case", ["two_tiles", "second_chunk"])
def test_dense_chain_matches_jax(case):
    sc = _Scene(*_stand_in(lights=12))
    kw = dict(GI, samples_per_pixel=3, max_bounces=3, tile_size=128)
    if case == "second_chunk":
        kw.update(gi_sample_offset=2, gi_chunk_weight=2)
    st = check_exact(sc, sc, kw, (16, 12), 7)
    assert st["children_pushed"] > 0


def test_dense_stack_matches_jax():
    def with_lights(s):
        return dataclasses.replace(s, static=dataclasses.replace(
            s.static, num_lights=tuple(8 if k else 0
                                       for k in s.static.num_lights)))
    jsc, sc = with_lights(jax_load_scene(EXAMPLE)), with_lights(
        load_scene(EXAMPLE))
    st = check_exact(jsc, sc, dict(GI, samples_per_pixel=2, max_bounces=2,
                                   light_chunk=8), (16, 16), 3)
    assert st["children_pushed"] > 0 and st["main_rays"] > 256


@pytest.mark.parametrize("scene", ["stand_in", "lit_soup"])
def test_spp_chunks_compose(scene):
    if scene == "stand_in":
        static, params = _stand_in(lights=8)
        cfg = RenderConfig(max_bounces=3, light_chunk=8, **GI,
                           samples_per_pixel=4)
    else:
        sc = jax_reorder(_lit_soup())
        static, params = sc.static, sc.params
        cfg = RenderConfig(max_bounces=2, light_chunk=4, **GI,
                           samples_per_pixel=4)
    single, _ = make_renderer(static, cfg, 16, 16, device="cpu")(
        params, PhiloxSampler(5, "cpu"))
    chunked, _ = render_spp_chunked(_Scene(static, params), cfg, 16, 16,
                                    PhiloxSampler(5, "cpu"), device="cpu",
                                    spp_chunks=2, host_tiled=False)
    assert single.max() > 0
    torch.testing.assert_close(torch.from_numpy(chunked), single, rtol=1e-4,
                               atol=1e-6)
    # the chunks differ from each other: GI is live in the frame
    a, _ = render_spp_chunked(
        _Scene(static, params), dataclasses.replace(cfg, samples_per_pixel=2),
        16, 16, PhiloxSampler(5, "cpu"), device="cpu", spp_chunks=1,
        host_tiled=False)
    assert float((torch.from_numpy(a) - single).abs().max()) > (
        1e-4 * float(single.max()))


"""The whole slice: the PyTorch port's ``make_renderer`` against the JAX
package's on the opaque stand-in scene, with the JAX uniforms injected.

The port draws every uniform through ``sampler.uniform(path, shape)`` with
``path = (tile, round, emitter, chunk)``; the sampler here replays the JAX
key chain for that path (api.py:56, integrator.py:245-246, shading.py:311
and :328), so both renderers shade the very same samples.

The JAX frame is evaluated op by op (``jax.disable_jit`` with
``remat=False``, which changes only what a backward pass would save): a
compiled XLA program contracts multiply-adds into FMAs, and the
cancellation in the sphere discriminant b² − c turns that one-rounding
difference into ~4e-6-relative hit distances at grazing hits.

Tolerances: ray counts exact; z equal zero pattern and rtol 1e-6; image
max abs diff <= 1e-5 · image max (float32 re-association between XLA and
torch in the shading sums).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import make_renderer as jax_make_renderer
from c_raytracer_tpu.scene import load_scene as jax_load_scene
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.render.integrator import GI_TAG
from c_raytracer_tpu_torch.scene import load_scene

SCENE = os.path.join(os.path.dirname(__file__), "..", "scenes",
                     "spheres_opaque.json")
EXACT_STATS = ("main_rays", "shadow_rays", "gi_rays", "children_pushed")


class JaxKeySampler:
    """Uniforms of the JAX renderer for a port sample path: the shading's
    ``(tile, round, emitter, chunk)``, a GI sample's direction ``(tile,
    round, GI_TAG, sample, 0)`` and its child's light chunks ``(tile,
    round, GI_TAG, sample, 1, emitter, chunk)`` (integrator.py:110-111
    there: the sample key ``fold_in(k_gi, sample)`` splits into the
    direction's key and the child's shading key)."""

    def __init__(self, key, n_tiles):
        self.tile_keys = jax.random.split(key, n_tiles)

    def uniform(self, path, shape):
        tile, round_i, *rest = path
        rkey = jax.random.fold_in(self.tile_keys[tile], round_i)
        k_shade, k_gi = jax.random.split(rkey)
        if rest[0] == GI_TAG:
            _, sample, part, *rest = rest
            k_dir, k_shade = jax.random.split(
                jax.random.fold_in(k_gi, sample))
            if part == 0:
                return self._draw(k_dir, shape)
        e_i, chunk = rest
        ckey = jax.random.fold_in(jax.random.fold_in(k_shade, e_i), chunk)
        return self._draw(ckey, shape)

    @staticmethod
    def _draw(key, shape):
        u = jax.random.uniform(key, shape, jnp.float32)
        return torch.from_numpy(np.array(u))


def _compare(static, params, kw, resx, resy, tile):
    n_tiles = -(-(resx * resy) // (tile or resx * resy))
    key = jax.random.PRNGKey(7)
    with jax.disable_jit():
        j_img, j_z, j_st = jax_make_renderer(
            static, JaxConfig(remat=False, **kw), resx, resy, jit=False,
            with_stats=True)(params, key)
    fn = make_renderer(static, RenderConfig(**kw), resx, resy, device="cpu",
                       with_stats=True)
    img, z, st = fn(params, JaxKeySampler(key, n_tiles))

    j_img, j_z = np.asarray(j_img), np.asarray(j_z)
    img, z = img.numpy(), z.numpy()
    assert img.shape == j_img.shape == (resy, resx, 3)
    assert z.shape == j_z.shape == (resy, resx)
    for k in EXACT_STATS:
        assert float(st[k]) == float(j_st[k]), k
    np.testing.assert_array_equal(z == 0, j_z == 0)
    np.testing.assert_allclose(z, j_z, rtol=1e-6, atol=0)
    assert np.all(np.isfinite(img)) and j_img.max() > 0
    assert np.abs(img - j_img).max() <= 1e-5 * j_img.max()
    return st


def _stand_in(lights=None):
    """The JAX package's load of the stand-in scene, optionally with the
    emitter's sample count changed."""
    sc = jax_load_scene(SCENE)
    if lights is None:
        return sc.static, sc.params
    nl = tuple(lights if n else 0 for n in sc.static.num_lights)
    return dataclasses.replace(sc.static, num_lights=nl), sc.params


@pytest.mark.parametrize("case", ["defaults_32", "tiled_blinn_lin_b3",
                                  "tail_chunk_12_lights"])
def test_render_matches_jax(case):
    if case == "defaults_32":
        static, params = _stand_in()
        st = _compare(static, params, {}, 32, 32, None)
        # ~110 rays per pixel: one primary ray plus 200 shadow rays per hit
        assert float(st["shadow_rays"]) > 0
    elif case == "tiled_blinn_lin_b3":
        static, params = _stand_in()
        kw = dict(tile_size=128, reflection_model="blinn",
                  light_attenuation="lin", max_bounces=3)
        _compare(static, params, kw, 24, 20, 128)   # 480 px -> 4 tiles, pad
    else:
        static, params = _stand_in(lights=12)       # lc=16, n_valid=12
        _compare(static, params, {}, 16, 16, None)


def test_port_loader_renders_same_as_jax_params():
    """The port's own loader feeds the port the same frame as the JAX
    package's params do."""
    sc = load_scene(SCENE)
    jsc = jax_load_scene(SCENE)
    key = jax.random.PRNGKey(3)
    fn = make_renderer(sc.static, RenderConfig(max_bounces=2), 8, 8,
                       device="cpu")
    a = fn(sc.params, JaxKeySampler(key, 1))
    b = fn(jsc.params, JaxKeySampler(key, 1))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)

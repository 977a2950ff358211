"""The port's mesh rendering in one process, against the JAX package:
stacked ``pr`` frames (``make_renderer(shards=S)``, the frame of S ``pr``
ranks), ``make_sharded_renderer`` on one rank, and ``make_mesh``'s layout
rules.  The ``sp`` replicas and the train step are in
tests/test_torch_parallel_train.py; ranks of a process group in
tests/test_torch_distributed.py.

Frames: the lit soup of tests/test_parallel.py (a transparent triangle
soup, or an opaque one, under an emitting sphere) at 16x16, against the
JAX package's unsharded ``make_renderer`` with the same config and the
JAX uniforms injected (``JaxKeySampler``), with exhaustive budgets as
tests/test_parallel.py holds its sharded frames: the image within its
atol 1e-6 on >= 99% of the pixels and within 1e-3·max everywhere (the
port's allowance for refracted rays against JAX, tests/
test_torch_union_render.py: XLA and torch round arccos, arcsin, sin and
cos differently), z at the port tests' rtol 1e-6 (tests/
test_torch_render.py; JAX's own atol 1e-5 is 1-3 ulps at the soup's
depths of 9-40), the ray counts exact; and against the port's unsharded
frame bit for bit, stats included.  The JAX side runs op by op
(``jax.disable_jit``, ``remat=False``).
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from c_raytracer_tpu.accel import reorder_scene as jax_reorder
from c_raytracer_tpu.render import RenderConfig as JaxConfig
from c_raytracer_tpu.render import make_renderer as jax_make_renderer
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.accel import reorder_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.parallel import make_mesh, make_sharded_renderer
from c_raytracer_tpu_torch.parallel.launch import _free_port
from c_raytracer_tpu_torch.parallel.mesh import Mesh
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import make_scene
from test_torch_render import JaxKeySampler
from test_torch_sharded import lit_kwargs

pytest_plugins = ("torch_harness",)

RES = 16


def lit(transparent=True, nt=600):
    kw = lit_kwargs(nt=nt, transparent=transparent)
    return jax_reorder(jax_make_scene(**kw)), reorder_scene(make_scene(**kw))


def npy(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


FRAMES = {
    # the dense range fold of transparent triangles (stack, per-chunk
    # shadows)
    "dense_transparent": (True, dict(accel="none")),
    # per-shard cluster sweeps, union shadows (transparent)
    "cluster_union": (True, dict(accel="cluster", bvh_visits=64,
                                 bvh_shadow_visits=64)),
    # per-shard cluster sweeps, the shared capsule sweep with a shortlist
    # that keeps every triangle (opaque)
    "cluster_shared_opaque": (False, dict(accel="cluster", bvh_visits=64,
                                          bvh_shadow_visits=64,
                                          bvh_shadow_shortlist=600)),
}


@pytest.mark.parametrize("case", list(FRAMES))
def test_stacked_pr_frame_matches_jax(case):
    transparent, kw = FRAMES[case]
    kw = dict(max_bounces=2, rounds=4, light_chunk=4, **kw)
    jsc, tsc = lit(transparent)
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        j_img, j_z, j_st = jax_make_renderer(
            jsc.static, JaxConfig(remat=False, **kw), RES, RES, jit=False,
            with_stats=True)(jsc.params, key)
    cfg = RenderConfig(**kw)
    sampler = JaxKeySampler(key, 1)
    img, z, st = make_renderer(tsc.static, cfg, RES, RES, device="cpu",
                               with_stats=True, shards=4)(tsc.params,
                                                          sampler)
    u_img, u_z, u_st = make_renderer(tsc.static, cfg, RES, RES,
                                     device="cpu", with_stats=True)(
        tsc.params, sampler)
    assert torch.equal(img, u_img) and torch.equal(z, u_z)
    assert {k: float(v) for k, v in st.items()} == \
        {k: float(v) for k, v in u_st.items()}
    assert float(j_img.max()) > 1e-3, "the frame must be lit"
    for k in ("main_rays", "shadow_rays", "children_pushed"):
        assert float(st[k]) == float(j_st[k]), k
    assert float(st["visit_spill_max"]) == 0.0
    diff = np.abs(npy(img) - np.asarray(j_img)).max(-1)
    assert diff.max() <= 1e-3 * float(j_img.max())
    assert (diff <= 1e-6).mean() >= 0.99
    np.testing.assert_allclose(npy(z), np.asarray(j_z), rtol=1e-6, atol=0)


def test_make_mesh_layout_and_refusals():
    """Without a process group only the 1x1x1 mesh exists; with one, a
    shape that does not cover the ranks raises ``ValueError`` (as the JAX
    package's does), and the default puts every rank on px."""
    m = make_mesh()
    assert m.shape == (1, 1, 1) and m.coord == (0, 0, 0)
    assert not m.distributed and m.group is None
    for shape in ((2,), (1, 2), (1, 1, 2)):
        with pytest.raises(ValueError):
            make_mesh(*shape)
    assert m.rank_of(0, 0, 0) == 0
    assert Mesh((2, 3, 4), (0, 0, 0)).rank_of(1, 2, 3) == 23
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        m = make_mesh()
        assert m.shape == (1, 1, 1) and m.distributed
        assert m.groups == (None, None, None)
        with pytest.raises(ValueError, match="2x1x1 != 1"):
            make_mesh(2)
        with pytest.raises(ValueError):
            make_mesh(n_sp=2)
    finally:
        dist.destroy_process_group()


def test_sharded_renderer_on_one_rank_is_make_renderer():
    """The 1x1x1 mesh renders ``make_renderer``'s frame, and with
    ``shards`` the stacked frame."""
    _, tsc = lit(True)
    cfg = RenderConfig(max_bounces=1, light_chunk=4, accel="cluster",
                       tile_size=64)
    ref = make_renderer(tsc.static, cfg, RES, RES, device="cpu",
                        with_stats=True)(tsc.params, PhiloxSampler(1, "cpu"))
    for shards in (None, 3):
        out = make_sharded_renderer(tsc.static, cfg, RES, RES, make_mesh(),
                                    device="cpu", with_stats=True,
                                    shards=shards)(tsc.params,
                                                   PhiloxSampler(1, "cpu"))
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        assert {k: float(v) for k, v in out[2].items()} == \
            {k: float(v) for k, v in ref[2].items()}

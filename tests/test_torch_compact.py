"""Closest-hit ray compaction (``closest_compact="on"``): the port's frames
and gradients with it against without it, bit for bit.

The sweep sorts a batch's rays by live visit-list length and folds them in
blocks that each stop at their own longest list
(``traverse._closest_scan_compact``); each ray folds its own list in the
same order, so image, z, stats and every leaf's gradient must be equal,
not close.  The block rule is the JAX package's (``intersect.py``
``_closest_compact_block``): 8192 rays down to 128, two or more blocks
(its loop can stop at 64; the port keeps the floor of 128),
and 0 where the first power of two that divides the batch makes one
block, so the JAX package's own test, whose 2,304-pixel frame runs in one
batch of its auto tile of 2,048, never compacts.  Here ``tile_size`` gives
batches of 384 rays, three blocks of 128, and a spy counts the compacted
sweeps.  Scenes: the reflective opaque soup of
tests/test_torch_mesh_render.py (chain integrator, path GI with its child
traces too) and the glass soup of tests/test_torch_union_render.py (stack
integrator).  Gradients are taken under
``torch.use_deterministic_algorithms`` (the row gathers' backward sums in
a thread-dependent order otherwise).
"""

import numpy as np
import pytest
import torch

from c_raytracer_tpu_torch.accel import intersect, traverse
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import RenderConfig, make_renderer
from c_raytracer_tpu_torch.scene import named_leaves, params_to_torch
from test_torch_mesh_render import lit_soup
from test_torch_union_render import glass_soup

CASES = {
    # (scene, config): 24x16 = 384 px, one tile
    "opaque": ("opaque", dict(max_bounces=2)),
    "opaque_path_gi": ("opaque", dict(max_bounces=1, gi_model="path",
                                      samples_per_pixel=2)),
    "glass": ("glass", dict(max_bounces=1)),
}


def scene(name):
    """The port's glass soup, or the opaque soup (the JAX package's
    Morton-ordered scene, which the port renders as it is)."""
    return glass_soup()[1] if name == "glass" else lit_soup()


def frame_and_grads(sc, kw, compact, spy):
    """(image, z, stats, {leaf: grad}) of sum(img·w) + sum(z·wz), and the
    compacted sweeps counted by ``spy``."""
    p = params_to_torch(sc.params, "cpu")
    for _, x in named_leaves(p):
        x.requires_grad_(True)
    fn = make_renderer(sc.static, RenderConfig(
        tile_size=384, light_chunk=8, closest_compact=compact, **kw), 24, 16,
        device="cpu", with_stats=True)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.uniform(size=(16, 24, 3)).astype(np.float32))
    wz = torch.from_numpy(rng.uniform(size=(16, 24)).astype(np.float32))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        spy.calls = 0
        img, z, st = fn(p, PhiloxSampler(5, "cpu"))
        ((img * w).sum() + (z * wz).sum()).backward()
    finally:
        torch.use_deterministic_algorithms(was)
    grads = {n: (x.grad if x.grad is not None else torch.zeros_like(x))
             for n, x in named_leaves(p)}
    return (img.detach(), z.detach(), {k: float(v) for k, v in st.items()},
            grads, spy.calls)


class CountCompacted:
    """Counts the calls of ``traverse._closest_scan_compact``."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = traverse._closest_scan_compact

        def counted(*a, **k):
            self.calls += 1
            return real(*a, **k)
        monkeypatch.setattr(traverse, "_closest_scan_compact", counted)


@pytest.mark.parametrize("case", list(CASES))
def test_compacted_frames_and_grads_are_bit_identical(case, monkeypatch):
    name, kw = CASES[case]
    sc = scene(name)
    spy = CountCompacted(monkeypatch)
    off = frame_and_grads(sc, kw, "off", spy)
    on = frame_and_grads(sc, kw, "on", spy)
    assert off[4] == 0 and on[4] > 0, (off[4], on[4])
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert on[2] == off[2]
    assert off[0].max() > 0 and off[2]["children_pushed"] > 0
    live = 0
    for leaf, g in off[3].items():
        assert torch.equal(on[3][leaf], g), leaf
        live += bool(g.abs().max() > 0) if g.numel() else 0
    assert live >= 6


@pytest.mark.parametrize("n_rays,block", [
    (256, 0), (384, 128), (320, 0), (192, 0), (16384, 8192), (24576, 8192), (2048, 0),
    (2304, 256), (4096, 0), (65536, 8192), (200, 0), (128, 0)])
def test_block_rule(n_rays, block):
    """The JAX package's rule: 0 at one block, so its auto tile of 2048
    rays never compacts; and, unlike it, no block under 128 rays (its loop
    stops at 64 for 192 or 320 rays)."""
    ds = type("DS", (), {})()
    ix = intersect.Intersector(ds=ds, static=None,
                               cfg=RenderConfig(closest_compact="on"))
    assert ix._closest_compact_block(n_rays) == block
    off = intersect.Intersector(ds=ds, static=None, cfg=RenderConfig())
    assert off._closest_compact_block(n_rays) == 0

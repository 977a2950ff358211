"""Gradients through path-traced GI on the cluster stack: the
128-triangle glass soup of tests/test_torch_grad_stack.py (union shadows
over 32-triangle shadow clusters, 8 light samples) at 12x12 with 2 samples
a pixel and 1 bounce, held against ``jax.grad`` with the loss and the
tolerances of tests/test_torch_grad.py.  It runs from a file of its own so
that each file takes about a minute alone on the CPU."""

import pytest

from test_torch_grad import check_grads
from test_torch_grad_stack import LIVE, soup_scenes

CASES = {
    "gi_glass_soup_union": dict(
        scenes=soup_scenes, res=(12, 12), live=LIVE,
        kw=dict(gi_model="path", samples_per_pixel=2, max_bounces=1,
                light_chunk=8, accel="cluster", bvh_cluster=16,
                bvh_shadow_cluster=32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax(case, monkeypatch):
    check_grads(case, monkeypatch, CASES)

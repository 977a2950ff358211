"""Path-traced GI on the cluster stack: the glass soup of
tests/test_torch_union_render.py (600 triangles in glass, union shadows)
at 16x16 with 2 samples a pixel and 2 bounces, the port against the JAX
package at the tolerances of tests/test_torch_gi_render.py: every pixel
within 1e-5 · max.  It runs from a file of its own so that
each file takes about a minute alone on the CPU."""

from test_torch_gi_render import check_exact
from test_torch_union_render import glass_soup


def test_glass_soup_matches_jax():
    jsc, sc = glass_soup()
    st = check_exact(jsc, sc, dict(gi_model="path", samples_per_pixel=2,
                                   max_bounces=2, light_chunk=8), (16, 16),
                     11)
    assert st["children_pushed"] > 0

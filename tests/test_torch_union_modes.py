"""The glass soup of tests/test_torch_union_render.py with per-ray shadows
and with a stack of 2 slots (whose overflow both packages drop and count
alike), against the JAX package at that file's tolerances.  They run from a
file of their own so that each file takes about a minute alone on the
CPU."""

import pytest

from test_torch_union_render import check_glass_soup


@pytest.mark.parametrize("mode", ["per_ray", "stack_of_2"])
def test_glass_soup_matches_jax(mode):
    check_glass_soup(mode)

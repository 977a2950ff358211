"""Gradients of the stack integrator on the cluster route: the cluster
case of tests/test_torch_grad_stack.py (a 128-triangle glass soup, union
shadows over 32-triangle shadow clusters), held against ``jax.grad`` with
that file's loss and tolerances.  It runs from a file of its own so that
each file takes under a minute alone on the CPU."""

import pytest

from test_torch_grad import check_grads
from test_torch_grad_stack import CASES

pytest_plugins = ("torch_harness",)


@pytest.mark.parametrize("case", [c for c in CASES if "cluster" in c])
def test_grads_match_jax(case, monkeypatch):
    check_grads(case, monkeypatch, CASES)

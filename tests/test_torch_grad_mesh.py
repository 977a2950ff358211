"""Gradients of the mesh path: the mesh cases of tests/test_torch_grad.py
(the 128-triangle bumpy mesh through the cluster route with shared
shortlist shadows, with per-ray shadows, and lit by a triangle emitter),
held against ``jax.grad`` with that file's loss and tolerances.  They run
from a file of their own so that each file takes under a minute alone on
the CPU."""

import pytest

from test_torch_grad import CASES, check_grads

pytest_plugins = ("torch_harness",)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("mesh")])
def test_grads_match_jax(case, monkeypatch):
    check_grads(case, monkeypatch)

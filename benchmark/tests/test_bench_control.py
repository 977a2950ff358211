"""The check fails what it must: the control (the reference at a lower
precision in the program's place) and a run whose timed path is broken
underneath (an altered answer, half the batch left out, a step that
leaves its state unchanged); an unbroken run passes.  On the CPU at small
sizes."""

import math

import pytest

from benchmark import check, core
from conftest import tiny_root


@pytest.fixture
def root(tmp_path):
    tiny_root(str(tmp_path), {"spheres512.step": 16,
                              "spheres1024.frame": 16}, stride=1)
    return str(tmp_path)


def run(root, name, hooks=None, seconds=0.3):
    out, lines = core.run(name, 2 ** 31 + 3, seconds, False, root=root,
                          device="cpu", hooks=hooks)
    return out


@pytest.mark.parametrize("name", ["spheres1024.frame", "spheres512.step"])
def test_control_fails(name, root):
    c = core.cell_of(core.load_spec(root), name, False, root)
    numbers = c.runner.control_numbers(c, 2 ** 31 + 7, "cpu")
    ok, _ = check.judge(numbers, c.limits)
    assert not ok, numbers
    # a number, not a crash or a NaN: the control sets an upper reading
    assert all(math.isfinite(numbers[k]) for k in c.limits), numbers


def test_unbroken_runs_pass(root):
    assert run(root, "spheres1024.frame")["correct"]
    assert run(root, "spheres512.step")["correct"]


@pytest.mark.parametrize("hooks", [
    {"output": lambda img, z: (img * 1.01, z)},
    "half",
], ids=["answer_altered", "half_the_batch"])
def test_broken_frames_fail(hooks, root):
    if hooks == "half":
        hooks = core.runner_module(root, "frame").HALF_HOOKS
    out = run(root, "spheres1024.frame", hooks)
    assert not out["correct"] and out["failed"] == 1


@pytest.mark.parametrize("hooks", [
    {"update": lambda leaves, names, lr: None},
    "half",
    {"output": lambda img, z: (img * 1.01, z)},
], ids=["state_unchanged", "half_the_batch", "answer_altered"])
def test_broken_steps_fail(hooks, root):
    if hooks == "half":
        hooks = core.runner_module(root, "step").HALF_HOOKS
    assert not run(root, "spheres512.step", hooks)["correct"]

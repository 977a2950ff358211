"""The frame diagnostics ``s5_union_bench`` and ``s5_trunc_sweep``
(c_raytracer_tpu_torch/tools/) against the JAX scripts
tools/profiling/s5_union_bench.py and s5_trunc_sweep.py.

Each JAX script runs whole with its scene load pointed at the glass soup
of tests/test_torch_union_render.py and its renderer factory replaced by a
recorder, which keeps each config it is given and hands back a seeded
numpy image per config (the i-th config built gets image i, with values
spread over six decades so that the bright-pixel threshold and the 1e-6
floor of the relative error both bite).  The port's tool runs with the
same recorder, so:

* each config it builds equals the JAX script's, field for field
  (``dataclasses.asdict``), and ``union_c128`` and ``union_c64`` resolve
  to the same 64-triangle shadow clusters in both packages;
* its lines equal the JAX script's apart from the seconds: radiance
  totals, max |Δ| and rel, the bright-pixel relative error.

The frames behind those configs go through ``make_renderer`` and
``make_host_tiled_renderer``, which tests/test_torch_union_render.py and
test_torch_union_modes.py hold against JAX.  Each tool's ``main`` runs on
the CPU at 4x4 on a scene file of the soup (JSON and binary STL) and
prints the JAX script's lines in order; without a card and without
``--device cpu`` it raises.
"""

import dataclasses
import importlib.util
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import c_raytracer_tpu.render as jax_render
import c_raytracer_tpu.scene as jax_scene
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.tools import s5_trunc_sweep, s5_union_bench
from test_torch_tool_s5_queries import shape_of, write_scene
from test_torch_union_render import glass_soup, glass_soup_kwargs

RES, LIGHTS = 8, 4
PROFILING = os.path.join(os.path.dirname(__file__), "..", "tools",
                         "profiling")
SECONDS = re.compile(r"\d+\.\d+ ?s")


class Recorder:
    """A renderer factory that keeps the configs it is given; the i-th
    renderer returns image i (and a zero z; stats when asked)."""

    def __init__(self, wrap):
        self.wrap, self.configs = wrap, []

    def __call__(self, static, cfg, resx, resy, **kw):
        g = np.random.default_rng(len(self.configs))
        img = (g.random((resy, resx, 3), dtype=np.float32)
               ** 6).astype(np.float32)
        self.configs.append(cfg)
        out = (self.wrap(img), self.wrap(np.zeros((resy, resx), np.float32)))
        stats = {"shadow_spill_max": 0.0, "visit_spill_max": 0.0}
        return lambda params, key: out + (stats,) if kw.get(
            "with_stats") else out


def run_jax_script(name, argv, factory, monkeypatch, capsys):
    """(printed lines, recorder) of tools/profiling/<name>.py on the soup
    with ``jax_render.<factory>`` recorded."""
    rec = Recorder(jnp.asarray)
    monkeypatch.setattr(jax_render, factory, rec)
    monkeypatch.setattr(jax_scene, "load_scene",
                        lambda path: jax_make_scene(**glass_soup_kwargs()))
    monkeypatch.setattr(sys, "argv", [name + ".py", *map(str, argv)])
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(PROFILING, name + ".py"))
    capsys.readouterr()
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    return capsys.readouterr().out.splitlines(), rec


def assert_same_configs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("which", [None, "per_ray,union_c32"])
def test_union_bench_matches_the_jax_script(which, monkeypatch, capsys):
    argv = (RES, LIGHTS) + ((which,) if which else ())
    want, jrec = run_jax_script("s5_union_bench", argv,
                                "make_host_tiled_renderer", monkeypatch,
                                capsys)
    rec = Recorder(torch.from_numpy)
    monkeypatch.setattr(s5_union_bench, "make_host_tiled_renderer", rec)
    _, sc = glass_soup()
    records, got = s5_union_bench.run(
        sc, RES, LIGHTS, which.split(",") if which else None, name="scene5",
        device="cpu")
    assert_same_configs(rec.configs, jrec.configs)
    assert [SECONDS.sub("#", s) for s in got] == [
        SECONDS.sub("#", s) for s in want]
    assert len(got) == 1 + (2 if which else 4)
    assert all("max|Δ| vs first" in s for s in got[2:])
    if which is None:
        # the stale label: union_c128 runs union_c64's shadow clusters
        for cfgs in (rec.configs, jrec.configs):
            assert [c.resolved_shadow_cluster(True) for c in cfgs] == [
                64, 64, 32, 16]
            assert [c.resolved_shadow_mode(True) for c in cfgs] == [
                "union"] * 3 + ["per_ray"]
        assert [r["shadow_cluster"] for r in records] == [64, 64, 32, 16]


def test_trunc_sweep_matches_the_jax_script(monkeypatch, capsys):
    want, jrec = run_jax_script("s5_trunc_sweep", (RES, LIGHTS),
                                "make_renderer", monkeypatch, capsys)
    rec = Recorder(torch.from_numpy)
    monkeypatch.setattr(s5_trunc_sweep, "make_renderer", rec)
    _, sc = glass_soup()
    records, got = s5_trunc_sweep.run(sc, RES, LIGHTS, device="cpu")
    assert_same_configs(rec.configs, jrec.configs)
    assert [SECONDS.sub("#", s) for s in got] == [
        SECONDS.sub("#", s) for s in want]
    assert len(got) == 6
    # the bright threshold leaves some pixels out, and the 1e-6 floor bites
    img = np.random.default_rng(0).random((RES, RES, 3),
                                          dtype=np.float32) ** 6
    assert (img < 0.01 * img.max()).any() and (img < 1e-6).any()
    assert [r["shadow_mode"] for r in records] == ["union"] * 6


@pytest.mark.parametrize("tool, factory", [
    (s5_union_bench, "make_host_tiled_renderer"),
    (s5_trunc_sweep, "make_renderer"),
], ids=["s5_union_bench", "s5_trunc_sweep"])
def test_main_on_the_cpu(tool, factory, monkeypatch, capsys, tmp_path):
    """Real frames at 4x4 (2 lights): the JAX script's lines in order,
    every number finite (a nan or inf would not parse as one)."""
    name = tool.__name__.split(".")[-1]
    want, _ = run_jax_script(name, (4, 2), factory, monkeypatch, capsys)
    scene = write_scene(tmp_path)
    assert tool.main(["4", "2", "--device", "cpu", "--scene", scene]) == 0
    got = capsys.readouterr().out.splitlines()
    assert [shape_of(s) for s in got[1:]] == [shape_of(s) for s in want[1:]]
    assert shape_of(got[0]) == shape_of(want[0]).replace(
        "scene#", "soup.json")


@pytest.mark.parametrize("tool", [s5_union_bench, s5_trunc_sweep],
                         ids=["s5_union_bench", "s5_trunc_sweep"])
def test_main_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["4"])

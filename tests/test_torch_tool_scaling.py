"""The scaling benchmark (c_raytracer_tpu_torch/tools/bench_scaling.py)
against the JAX tool (tools/bench_scaling.py), on gloo CPU ranks (one torch
thread a rank) at 16x16.

The JAX tool is run with its scene load pointed at the stand-in and its
sharded renderer replaced by a recorder (no compile; a fixed memory
analysis), which hands back the config and the frame size it builds and
its printed lines:

* ``main`` at counts 1 and 2 prints one JSON line a count and then the
  ``scaling`` line, each entry with every key of the JAX tool's lines;
  on CPU ranks the memory keys and ``mem_shrink`` are null and no card is
  shared.
* The tool's config is the JAX tool's, field for field, apart from its
  tile (the frame in ``TILES`` tiles), at the JAX tool's 256x256; the
  one-process frame under that config at 16x16 matches JAX's
  ``make_renderer`` with the JAX draws injected, to the tolerances of
  tests/test_torch_render.py (JAX op by op).
* The two-rank frame (rank 0's, gathered over the px mesh) is bit-equal to
  one process's ``make_renderer`` frame under the same config and seed.
* Under NCCL without a card the tool raises, as ``launch`` does: there is
  no fallback to gloo or the CPU.
"""

import dataclasses
import functools
import importlib.util
import inspect
import json
import os
import time
import types

import jax.numpy as jnp
import pytest
import torch

import c_raytracer_tpu.parallel.render_sharded as jax_render_sharded
import c_raytracer_tpu.scene as jax_scene
from c_raytracer_tpu_torch.core.rng import PhiloxSampler
from c_raytracer_tpu_torch.render import make_renderer
from c_raytracer_tpu_torch.scene import load_scene
from c_raytracer_tpu_torch.tools import bench_scaling
from test_torch_render import _compare

RES = 16
JAX_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "bench_scaling.py")


class _RecordedRenderer:
    """Stands in for the JAX tool's compiled sharded renderer."""

    def lower(self, params, key):
        analysis = types.SimpleNamespace(temp_size_in_bytes=4096,
                                         argument_size_in_bytes=512)
        return types.SimpleNamespace(compile=lambda: types.SimpleNamespace(
            memory_analysis=lambda: analysis))

    def __call__(self, params, key):
        time.sleep(0.01)
        return jnp.zeros((1,)), jnp.zeros((1,))


def _jax_tool(monkeypatch, capsys, counts):
    """(the JAX tool's printed lines, [(config, width, height)] it built)."""
    for var in ("JAX_PLATFORMS", "XLA_FLAGS"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    load = jax_scene.load_scene
    monkeypatch.setattr(jax_scene, "load_scene",
                        lambda path: load(bench_scaling.SCENE))
    built = []

    def make(static, cfg, width, height, mesh):
        built.append((cfg, width, height))
        return _RecordedRenderer()

    monkeypatch.setattr(jax_render_sharded, "make_sharded_renderer", make)
    spec = importlib.util.spec_from_file_location("jax_bench_scaling",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(counts)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    return lines, built


def test_main_prints_the_jax_tools_lines(monkeypatch, capsys):
    jlines, _ = _jax_tool(monkeypatch, capsys, [1, 2])
    assert len(jlines) == 3
    monkeypatch.setattr(bench_scaling, "run",
                        functools.partial(bench_scaling.run, res=RES))
    bench_scaling.main(["1", "2", "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert len(lines) == 3
    per_count, scaling = lines[:2], lines[2]["scaling"]
    for got, want in zip(per_count, jlines[:2]):
        assert set(want) <= set(got)
    for got, want in zip(scaling, jlines[2]["scaling"]):
        assert set(want) <= set(got)
    assert [r["devices"] for r in per_count] == [1, 2]
    assert [r["devices"] for r in scaling] == [1, 2]
    for r in scaling:
        assert r["seconds"] > 0 and r["shared_card"] is False
        assert r["temp_bytes_per_device"] is None
        assert r["argument_bytes_per_device"] is None
        assert r["mem_shrink"] is None
        assert r["efficiency"] == pytest.approx(r["speedup"] / r["devices"])
    assert scaling[0]["speedup"] == 1.0
    assert scaling[1]["speedup"] == pytest.approx(
        scaling[0]["seconds"] / scaling[1]["seconds"])


def test_config_and_frame_match_jax(monkeypatch, capsys):
    _, built = _jax_tool(monkeypatch, capsys, [1])
    (jcfg, width, height), = built
    res = inspect.signature(bench_scaling.run).parameters["res"].default
    assert (width, height) == (res, res)
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(bench_scaling.scaling_config(res))
    assert got.pop("tile_size") == res * res // bench_scaling.TILES
    want.pop("tile_size")
    assert got == want

    cfg = bench_scaling.scaling_config(RES)
    kw = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "remat"}
    sc = jax_scene.load_scene(bench_scaling.SCENE)
    st = _compare(sc.static, sc.params, kw, RES, RES, cfg.tile_size)
    assert float(st["main_rays"]) > RES * RES


def test_two_rank_frame_is_one_process_frame():
    _, frames = bench_scaling.run([2], res=RES, backend="gloo", device="cpu",
                                  threads=1, keep_frames=True)
    sc = load_scene(bench_scaling.SCENE)
    cfg = bench_scaling.scaling_config(RES)
    assert -(-RES * RES // cfg.tile_size) == bench_scaling.TILES
    img, z = make_renderer(sc.static, cfg, RES, RES, device="cpu")(
        sc.params, PhiloxSampler(bench_scaling.TIMED_SEED, "cpu"))
    assert torch.equal(frames[2][0], img) and torch.equal(frames[2][1], z)
    assert img.max() > 0


def test_nccl_without_a_card_raises():
    with pytest.raises(RuntimeError, match="nccl needs one card a rank"):
        bench_scaling.main([])
    with pytest.raises(RuntimeError, match="nccl needs one card a rank"):
        bench_scaling.run([2], res=RES, backend="nccl", device="cuda")

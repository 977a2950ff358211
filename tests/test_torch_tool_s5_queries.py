"""The query diagnostics ``s5_diag`` and ``s5_union_stats``
(c_raytracer_tpu_torch/tools/) against the JAX scripts
tools/profiling/s5_diag.py and s5_union_stats.py.

Each JAX script runs whole, op by op (``jax.disable_jit()``), with its
scene load pointed at the 600-triangle glass soup of
tests/test_torch_union_render.py (Morton-ordered by the script, as the
port's soup is) and ``sys.argv`` set to 8x8 (``s5_union_stats`` with a
chunk of 4 samples).  The port's tool runs on the same soup with the JAX
draws injected: its sampler returns the JAX ``rng.uniform`` draw under
``fold_in(PRNGKey(0), 7)`` at path ``(7,)``.  Each printed line equals the
JAX script's apart from the t and tint errors, which are within rtol 1e-5
of JAX's; every count is equal.

Each tool's ``main`` runs on the CPU at 4x4 on a scene file the test
writes (a JSON and a binary STL of the soup's triangles) and prints the
JAX script's lines in order; without a card and without ``--device cpu``
it raises.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

import c_raytracer_tpu.scene as jax_scene
from c_raytracer_tpu.core import rng as jax_rng
from c_raytracer_tpu.scene import make_scene as jax_make_scene
from c_raytracer_tpu_torch.scene.stl import save_stl
from c_raytracer_tpu_torch.tools import s5_diag, s5_union_stats
from test_torch_union_render import glass_soup, glass_soup_kwargs

RES, LC = 8, 4
PROFILING = os.path.join(os.path.dirname(__file__), "..", "tools",
                         "profiling")
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")


def run_jax_script(name, argv, monkeypatch):
    """The printed lines of tools/profiling/<name>.py run op by op on the
    glass soup."""
    monkeypatch.setattr(jax_scene, "load_scene",
                        lambda path: jax_make_scene(**glass_soup_kwargs()))
    monkeypatch.setattr(sys, "argv", [name + ".py", *map(str, argv)])
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(PROFILING, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    buf = io.StringIO()
    with jax.disable_jit(), contextlib.redirect_stdout(buf):
        spec.loader.exec_module(mod)
    return buf.getvalue().splitlines()


@functools.lru_cache(maxsize=None)
def _jax_lines(name, argv):
    with pytest.MonkeyPatch.context() as mp:
        return tuple(run_jax_script(name, argv, mp))


class JaxChunkSampler:
    """The JAX script's light chunk: ``rng.uniform`` under
    ``fold_in(PRNGKey(0), 7)``, drawn at the port's path ``(7,)``."""

    def uniform(self, path, shape):
        assert tuple(path) == s5_union_stats.CHUNK_PATH
        key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
        return torch.from_numpy(np.array(jax_rng.uniform(key, shape)))


def assert_lines_match(got, want, rtol=1e-5):
    """Equal text and numbers, apart from numbers in e-notation (the
    errors), which agree within ``rtol``."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            if "e" in b:
                np.testing.assert_allclose(float(a), float(b), rtol=rtol,
                                           atol=0, err_msg=f"{g!r} {w!r}")
            else:
                assert a == b, (g, w)


def shape_of(line):
    """A line with its numbers and runs of spaces collapsed."""
    return " ".join(NUMBER.sub("#", line).split())


def test_diag_matches_the_jax_script():
    want = _jax_lines("s5_diag", (RES,))
    _, sc = glass_soup()
    records, got = s5_diag.run(sc, RES, device="cpu")
    assert_lines_match(got, want)
    assert len(want) == 1 + 3 + 1 + 6 + 1
    assert [r["query"] for r in records] == (
        ["scene"] + ["closest"] * 3 + ["closest_spill"] + ["shadow"] * 6
        + ["shadow_spill"])


def test_union_stats_matches_the_jax_script():
    want = _jax_lines("s5_union_stats", (RES, LC))
    _, sc = glass_soup()
    records, got = s5_union_stats.run(sc, RES, LC, sampler=JaxChunkSampler(),
                                      device="cpu")
    assert_lines_match(got, want, rtol=0)
    assert [(r["level"], r["size"]) for r in records] == [
        ("clusters", 16), ("clusters", 32), ("clusters", 64),
        ("clusters", 128), ("super", 16), ("super", 64)]
    # every segment's count at least 1 somewhere; the union bounds a count
    assert records[0]["per_seg"].max() > 0
    for r in records:
        per_seg = r["per_seg"].reshape(LC, -1)
        assert (per_seg.max(0) <= r["per_px"]).all()


def test_overlap_mask_and_super_boxes():
    """A segment overlaps a box ahead of its origin only up to its
    distance, never one behind it; a super box is the hull of its group's
    clusters, the last group's padding (lo = +inf, hi = -inf) taking no
    part."""
    lo = torch.tensor([[0.0, 0.0, 0.0], [-3.0, 0.0, 0.0]])
    hi = lo + 1.0
    o = torch.tensor([[-1.0, 0.5, 0.5]] * 2)
    d = torch.tensor([[1.0, 0.0, 0.0]] * 2)
    m = s5_union_stats.seg_overlap_mask(lo, hi, o, d, torch.tensor([5., .5]))
    assert m.tolist() == [[True, False], [False, False]]
    g = torch.Generator().manual_seed(0)
    cs = types.SimpleNamespace(lo=torch.rand((5, 3), generator=g))
    cs.hi = cs.lo + torch.rand((5, 3), generator=g)
    slo, shi = s5_union_stats.super_boxes(cs, 2)
    assert torch.equal(slo, torch.stack([cs.lo[:2].amin(0),
                                         cs.lo[2:4].amin(0), cs.lo[4]]))
    assert torch.equal(shi, torch.stack([cs.hi[:2].amax(0),
                                         cs.hi[2:4].amax(0), cs.hi[4]]))


def write_scene(tmp_path, nt=600):
    """The glass soup as a JSON scene and a binary STL of its triangles."""
    kw = glass_soup_kwargs(nt)
    stl = tmp_path / "soup.stl"
    save_stl(str(stl), np.asarray(kw["tri_vertices"], np.float32))

    def material(i, m):
        tex = ({"type": "checkerboard",
                "colors": [m["tex_color"], m["tex_color2"]],
                "scale": m["tex_scale"]} if m.get("tex_type") == 1
               else {"type": "uniform", "color": m["tex_color"]})
        return {"id": i + 1, "ks": m.get("ks", [0] * 3),
                "ka": m.get("ka", [0] * 3), "kr": m.get("kr", [0] * 3),
                "kt": m.get("kt", [0] * 3), "ke": m.get("ke", [0] * 3),
                "shininess": m.get("shininess", 1),
                "refractive_index": m.get("refractive_index", 1),
                "texture": tex}

    objects = [{"type": "Mesh", "parameters": dict(
        material=1, filename=str(stl), position=[0, 0, 0],
        rotation=[0, 0, 0], scale=1)}]
    objects += [{"type": "Sphere", "parameters": dict(
        material=mat + 1, position=c, radius=r,
        **({"lights": n} if n else {}))}
        for c, r, mat, n in zip(kw["sphere_center"], kw["sphere_radius"],
                                kw["sphere_material"], kw["sphere_lights"])]
    objects += [{"type": "Plane", "parameters": dict(
        material=kw["plane_material"][0] + 1,
        position=kw["plane_point"][0], normal=kw["plane_normal"][0])}]
    path = tmp_path / "soup.json"
    path.write_text(json.dumps({
        "AmbientLight": [0.15, 0.15, 0.18], "Camera": kw["camera"],
        "Materials": [material(i, m) for i, m in
                      enumerate(kw["materials"])],
        "Objects": objects}))
    return str(path)


@pytest.mark.parametrize("tool, argv, jax_argv", [
    (s5_diag, ["4"], ("s5_diag", (RES,))),
    (s5_union_stats, ["4", "2"], ("s5_union_stats", (RES, LC))),
], ids=["s5_diag", "s5_union_stats"])
def test_main_on_the_cpu(tool, argv, jax_argv, capsys, tmp_path):
    want = [shape_of(s) for s in _jax_lines(*jax_argv)]
    capsys.readouterr()
    scene = write_scene(tmp_path)
    assert tool.main(argv + ["--device", "cpu", "--scene", scene]) == 0
    got = capsys.readouterr().out.splitlines()
    assert [shape_of(s) for s in got] == want
    assert got[0].startswith("tris 600 ")


@pytest.mark.parametrize("tool", [s5_diag, s5_union_stats],
                         ids=["s5_diag", "s5_union_stats"])
def test_main_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["4"])

"""BENCHMARK.json against the benchmark's contract, and the harness found
by names: a throwaway cell, configuration, traffic mix and per-layer
metric added as files and entries only, run on the CPU."""

import json
import os
import re
import shutil

import pytest

from benchmark import core
from conftest import ROOT, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_and_sizes():
    s = spec()
    assert set(s) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    n_max = 24
    total = ((2 + 14 * n_max) * (s["run_seconds"] + 60)
             + n_max * 2 * 90 + 1200)
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_keys(section):
    s = spec()
    names = [e["name"] for e in s[section]]
    assert len(names) == len(set(names))
    for e in s[section]:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if section == "configs":
            assert 1 <= len(e["source"]) <= 200
        else:
            assert not set(e) - {"name", "unit", "better", "bound", "source",
                                 "layer", "moves", "workloads", "config",
                                 "traffic", "chips", "why"}
        if section in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
            assert os.path.exists(os.path.join(
                ROOT, "benchmark", "metrics", f"{e['name']}.py"))


def test_metric_rules():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    cells = {w["name"] for w in s["workloads"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:   # setup_s, another end-to-end and a per-layer metric
        assert sum(w in m.get("workloads", cells)
                   for m in s["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in s["per_layer"])


def test_every_cell_has_its_files():
    s = spec()
    confs = {c["name"]: c for c in s["configs"]}
    for c in s["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert {"source", "reduced", "assumed"} <= set(doc)
        assert doc["reduced"] == c["reduced"]
    for w in s["workloads"]:
        assert w["config"] in confs and w["chips"] == 1
        for path in (f"traffic/{w['traffic']}.json",
                     f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(ROOT, "benchmark", path))
    used = {w["config"] for w in s["workloads"]}
    assert used == set(confs)


THROWAWAY_METRIC = '''"""frames_done.check: the frames the window completed."""


def read(ctx):
    return float(ctx["n"]) if "times" in ctx else None
'''

THROWAWAY_LAYER_METRIC = '''"""shadow_calls.check: kernel 2's entry calls a traced frame, captured
by a wrap."""


def _keep(u, px, scal_f, n_valid, **_):
    return int(px.shape[1])


WRAPS = [("c_raytracer_tpu_torch.render.fused_shadow", "fused_chunk",
          _keep)]


def read(ctx):
    return len(ctx["calls"]) / ctx["n"] if ctx["calls"] else None
'''

THROWAWAY_RUNNER = '''"""Frames of another entry: here the frame runner's, reached by name."""

import os

from benchmark import core

_frame = core.runner_module(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "frame")

ITERATION = "frame"
Runner = _frame.Runner
reference_numbers = _frame.reference_numbers
'''


def test_a_cell_added_as_files_only(tmp_path):
    """A new configuration, traffic mix, runner, limits file, end-to-end
    metric reader and per-layer reader with a wrap, each a new file, and
    new entries: the harness runs the new cell, traced and not, and
    reports the new metrics without an edit to its code."""
    root = str(tmp_path)
    tiny_root(root, {})
    bench = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(bench, "configs", "spheres_opaque.json"),
                os.path.join(bench, "configs", "throwaway_spheres.json"))
    with open(os.path.join(bench, "traffic", "throwaway.json"), "w") as f:
        json.dump({"kind": "throwaway_kind", "resolution": 8, "render":
                   {"light_chunk": 16}, "trace_iters": 2,
                   "check": {"frames": 1, "stride": 1}}, f)
    with open(os.path.join(bench, "runners", "throwaway_kind.py"),
              "w") as f:
        f.write(THROWAWAY_RUNNER)
    with open(os.path.join(bench, "limits", "throwaway.frame.json"),
              "w") as f:
        json.dump({"off_share": {"limit": 0.01}}, f)
    with open(os.path.join(bench, "metrics", "frames_done.check.py"),
              "w") as f:
        f.write(THROWAWAY_METRIC)
    for name in ("shadow_calls.check", "shadow_calls.stepcheck"):
        with open(os.path.join(bench, "metrics", f"{name}.py"), "w") as f:
            f.write(THROWAWAY_LAYER_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["configs"].append({"name": "throwaway_spheres", "source": "test",
                         "file": "benchmark/configs/throwaway_spheres.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "throwaway.frame", "chips": 1,
                           "config": "throwaway_spheres",
                           "traffic": "throwaway", "why": "test"})
    s["end_to_end"].append({"name": "frames_done.check", "unit": "frames",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["throwaway.frame"]})
    s["per_layer"].append({"name": "shadow_calls.check", "unit": "calls",
                           "better": "lower", "source": "program_counter",
                           "layer": "test", "moves": "frame_s",
                           "workloads": ["throwaway.frame"]})
    s["per_layer"].append({"name": "shadow_calls.stepcheck",
                           "unit": "calls", "better": "lower",
                           "source": "program_counter", "layer": "test",
                           "moves": "step_s",
                           "workloads": ["spheres512.step"]})
    for m in s["end_to_end"]:
        if m["name"] == "frame_s":
            m["workloads"].append("throwaway.frame")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    out, lines = core.run("throwaway.frame", 2 ** 31 + 11, 0.5, False,
                          root=root, device="cpu")
    assert out["correct"], lines
    assert out["metrics"]["frames_done.check"]["value"] == out["attempted"]
    assert out["metrics"]["frame_s"]["value"] > 0
    assert set(out["metrics"]) == {"setup_s", "frame_s",
                                   "frames_done.check"}
    assert list(out)[-1] == "check"
    out, lines = core.run("throwaway.frame", 2 ** 31 + 11, 0.5, True,
                          root=root, device="cpu")
    assert out["correct"], lines
    assert out["attempted"] == 2 and "breakdown" in out
    # the light's chunks: the replayed frames called the wrapped entry
    assert out["metrics"]["shadow_calls.check"]["value"] >= 1
    # and the replayed steps (forward and backward, no update)
    out, lines = core.run("spheres512.step", 2 ** 31 + 11, 0.5, True,
                          root=root, device="cpu")
    assert out["correct"], lines
    assert out["metrics"]["shadow_calls.stepcheck"]["value"] >= 1


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and ``benchmark/``
    the run fails and prints no result."""
    import subprocess
    import sys
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "spheres1024.frame", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()

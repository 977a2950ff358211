"""Nothing a cell runs loads JAX or the JAX package, compared by whole
top-level module names; the reference and the harness's arithmetic load
nothing of the program; the harness names what it finds."""

import ast
import os
import subprocess
import sys

from benchmark import core
from conftest import ROOT

CELL_IMPORTS = """
import sys
from benchmark import core
root = sys.argv[1]
for name in ("spheres1024.frame", "glass32.frame"):
    cell = core.cell_of(core.load_spec(root), name, True, root)
    cell.runner.Runner(cell, 1, "cpu", {})
from benchmark import reference, control
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_IMPORTS = """
import sys
from benchmark import check, reference, yardstick
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code, ROOT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(out.stdout.split())


def test_a_cell_loads_no_jax():
    names = loaded(CELL_IMPORTS)
    assert "c_raytracer_tpu_torch" in names
    assert not names & set(core.JAX_NAMES), names & set(core.JAX_NAMES)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE_IMPORTS)
    assert not names & {"c_raytracer_tpu_torch", *core.JAX_NAMES}


def test_the_reference_imports_only_torch_numpy_and_the_stdlib():
    allowed = {"__future__", "dataclasses", "hashlib", "json", "math", "os",
               "numpy", "torch"}
    with open(os.path.join(ROOT, "benchmark", "reference.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            got = {(node.module or "").split(".")[0]}
        else:
            continue
        assert got <= allowed, got


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "c_raytracer_tpu_torch_fake", object())
    assert core.jax_modules() == []
    monkeypatch.setitem(sys.modules, "c_raytracer_tpu.render", object())
    assert core.jax_modules() == ["c_raytracer_tpu"]

"""The benchmark's tests, all on the CPU.  Run from the repository's
root:

    python3 -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_root(tmp, sizes: dict, stride: int = 1):
    """A checkout of the benchmark in ``tmp``: ``BENCHMARK.json`` and
    ``benchmark/`` copied, the meshes linked, and each cell given a
    throwaway traffic file at ``sizes[cell]`` pixels a side (new files
    only, as a later change would add them)."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "assets"), os.path.join(tmp, "assets"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        with open(os.path.join(tmp, "benchmark", "traffic",
                               f"{w['traffic']}.json")) as f:
            t = json.load(f)
        t["resolution"] = sizes.get(w["name"], 8)
        if "check" in t:
            t["check"]["stride"] = stride
        w["traffic"] = f"tiny_{w['traffic']}"
        with open(os.path.join(tmp, "benchmark", "traffic",
                               f"{w['traffic']}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return spec

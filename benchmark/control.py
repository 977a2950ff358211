"""Readings for the limits of the check (``limits/<workload>.json``), on
the card at the cell's own size, many seeds in one process:

    python3 -m benchmark.control --workload <name> --side program \\
        --seeds 1 2 3 ...
    python3 -m benchmark.control --workload <name> --side control \\
        --seeds 1 2 3

``program``: the numbers the check reads for the frames a run keeps (the
timed path's entry at the cell's size, the same draws), or for a run's
first three gradient steps, against the float32 reference: the lower
readings.  ``control``: the same numbers with the reference itself put in
the program's place at a lower precision (the runner's
``control_numbers``): the upper readings.  ``half``: the program with
half of the batch left out (the runner's ``HALF_HOOKS``), a fault's
readings.  The benchmark's own runs never run this.  Prints one JSON line
a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark import core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control", "half"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    core.cache_dirs(root)
    cell = core.cell_of(core.load_spec(root), args.workload, False, root)
    mod = cell.runner
    fn = {"program": mod.program_numbers,
          "control": mod.control_numbers,
          "half": lambda c, s, d: mod.program_numbers(c, s, d,
                                                      mod.HALF_HOOKS)
          }[args.side]
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = fn(cell, seed, args.device)
        numbers = {k: v for k, v in numbers.items() if not k.startswith("_")}
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, **numbers,
                          "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

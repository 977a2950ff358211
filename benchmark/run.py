"""One run of one cell of ``BENCHMARK.json``, from the repository's root:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the check's numbers beside their limits on standard error and, as
the last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``check`` last).  Exits 3 without a result where the
cell's CUDA cards are missing.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t0=T0))

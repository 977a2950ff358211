"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything a cell needs is found by name, each in a file of its own: its
configuration (``configs/<config>.json``, a scene file of the program's
JSON with the benchmark's keys beside it), its traffic
(``traffic/<traffic>.json``: the runner, the frame size, render
overrides, the check's sampling, the traced iterations), its runner
(``runners/<kind>.py``, the ``kind`` its traffic names), its limits
(``limits/<workload>.json``) and each metric's reader
(``metrics/<name>.py``).

A runner module defines ``ITERATION`` (what one iteration of the window
is: ``"frame"``, ``"step"``), ``Runner(cell, seed, device, hooks)`` with
``setup()``, ``iteration(timed)``, ``sync()``, ``after()`` (after an
iteration's synchronize, or after the profiler), ``replay(indices)``,
``record()``, ``spans`` and ``prog.device``, and
``reference_numbers(cell, record, seed, device)``, the check's numbers;
for ``control.py`` also ``program_numbers``, ``control_numbers`` and
``HALF_HOOKS``, and optionally ``notes(record)``, lines for standard
error.  ``hooks`` break the timed path for the tests of the check.

A reader defines ``read(ctx)``, which returns the metric's value or None
where it finds nothing to read, and may define ``WRAPS``, (module,
attribute, keep) triples: after a traced window the harness runs the
traced iterations again, untraced and after the memory's peak is read,
with each such attribute of the program wrapped so that ``keep(*args,
**kwargs)`` sees every call; what it returns, unless None, is kept in
``ctx["calls"]`` of that reader.

A run: set-up (the program's imports and kernel build, the scene, the
entry, the warm-up), then a closed loop of iterations for ``--seconds``
(``--trace 0``), or ``trace_iters`` iterations under ``torch.profiler``
(``--trace 1``), then the check against the plain reference, which runs
on the card once the program's state is freed.  Iteration ``i`` draws
from ``PhiloxSampler(iter_seed(seed, i))``.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

from benchmark import check

JAX_NAMES = ("jax", "jaxlib", "flax", "c_raytracer_tpu")
DEFAULT_TRACE_ITERS = 3


class NoCard(RuntimeError):
    """The cell's cards are not there."""


def iter_seed(seed: int, i) -> int:
    """The sampler seed of iteration ``i`` of a run (60 bits)."""
    return int(hashlib.sha256(f"{int(seed)}/{i}".encode()).hexdigest()[:15],
               16)


def cache_dirs(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the program's
    nvcc output already lands in ``c_raytracer_tpu_torch/_build``)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(JAX_NAMES))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_path: str
    traffic: dict
    runner: object         # the runner module of the traffic's kind
    metrics: list          # BENCHMARK.json entries this run reports
    readers: dict          # metric name -> reader module
    limits: dict


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(root: str, folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module of its own."""
    path = os.path.join(root, "benchmark", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner_module(root: str, kind: str):
    return _load(root, "runners", kind)


def reader(root: str, name: str):
    """The metric reader ``metrics/<name>.py``: a reader that reports
    another's quantity under a name of its own takes ``read`` (and
    ``WRAPS``) from it."""
    return _load(root, "metrics", name)


def cell_of(spec: dict, workload: str, trace: bool, root: str) -> Cell:
    """The cell named ``workload``, with the metrics a run of this kind
    reports: end-to-end ones without a trace, per-layer ones with."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config_path = os.path.join(root, conf["file"])
    with open(config_path) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    entries = [m for m in spec["per_layer" if trace else "end_to_end"]
               if workload in m.get("workloads", [workload])]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                config_path=config_path, traffic=traffic,
                runner=runner_module(root, traffic["kind"]), metrics=entries,
                readers={m["name"]: reader(root, m["name"])
                         for m in entries},
                limits=check.limits(root, workload))


class _Wraps:
    """The readers' wraps of program attributes, installed while open."""

    def __init__(self, readers: dict):
        self.items = [(name, mod, attr, keep) for name, r in readers.items()
                      for mod, attr, keep in getattr(r, "WRAPS", ())]
        self.captures = {name: [] for name in readers}
        self.real = []

    def __enter__(self):
        for name, modname, attr, keep in self.items:
            mod = importlib.import_module(modname)
            real = getattr(mod, attr)
            kept = self.captures[name]

            def wrapper(*a, _real=real, _keep=keep, _kept=kept, **k):
                rec = _keep(*a, **k)
                if rec is not None:
                    _kept.append(rec)
                return _real(*a, **k)

            # the program counts its launches on the module's name
            wrapper.launches = getattr(real, "launches", 0)
            setattr(mod, attr, wrapper)
            self.real.append((mod, attr, real))
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self.real):
            setattr(mod, attr, real)


def _power_limit() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# -- one run --------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: str, device: str = "cuda", t0: float | None = None,
        hooks: dict | None = None) -> tuple[dict, list]:
    """One run of one cell: (the result line's object, the check's lines
    for standard error).  ``hooks`` break the timed path for the tests of
    the check (see the runners)."""
    t0 = time.perf_counter() if t0 is None else t0
    cache_dirs(root)
    cell = cell_of(load_spec(root), workload, trace, root)
    import torch
    if device == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            raise NoCard(f"{workload} needs {cell.chips} CUDA card(s); "
                         f"{torch.cuda.device_count()} available")
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    t_imports = time.perf_counter()
    mod = cell.runner
    runner = mod.Runner(cell, seed, device, hooks or {})
    t_program = time.perf_counter()
    runner.setup()
    runner.sync()
    setup_s = time.perf_counter() - t0
    parts = (f"setup: {t_imports - t0:.2f} s to the card, "
             f"{t_program - t_imports:.2f} s the program's imports, scene "
             f"and entry, {t0 + setup_s - t_program:.2f} s the warm-up")

    if trace:
        window = _traced(cell, runner)
    else:
        window = _timed(runner, seconds)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    if trace:
        window["captures"] = _captures(cell, runner, window["indices"])
    power = _power_limit() if device == "cuda" else None
    ctx = dict(iteration=mod.ITERATION, setup_s=setup_s, peak_bytes=peak,
               **window)
    metrics = {}
    for m in cell.metrics:
        v = cell.readers[m["name"]].read(
            {**ctx, "calls": ctx.get("captures", {}).get(m["name"], [])})
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, once the program's state is freed
    record = runner.record()
    del runner
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = mod.reference_numbers(cell, record, seed, device)
    check_s = time.perf_counter() - t_check
    correct, shown = check.judge(numbers, cell.limits)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power}
    if trace:
        dev.update(busy_s=window["busy_s"], window_s=window["span_s"])
    out = {"correct": correct, "attempted": window["n"],
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": dev}
    if trace:
        out["breakdown"] = window["breakdown"]
    out["check"] = shown
    if "times" in window:
        t = sorted(window["times"])
        parts += (f"; window: {len(t)} iterations in {window['window_s']:.3f}"
                  f" s, each {t[0]:.4f} / {t[len(t) // 2]:.4f} / {t[-1]:.4f}"
                  f" s (min / median / max)")
    lines = [parts] + list(getattr(mod, "notes", lambda r: [])(record)) + [
        f"check: the reference took {check_s:.1f} s"]
    if "_leaves" in numbers:
        lines.append(f"check worst leaves: {numbers['_leaves']}")
    lines += [f"check {k}: {numbers.get(k)!r} (limit {lim!r})"
              for k, lim in cell.limits.items()]
    return out, lines


def _timed(runner, seconds: float) -> dict:
    times = []
    start = time.perf_counter()
    while not times or time.perf_counter() - start < seconds:
        a = time.perf_counter()
        runner.iteration(timed=True)
        runner.sync()
        times.append(time.perf_counter() - a)
        runner.after()
    return dict(n=len(times), times=times,
                window_s=time.perf_counter() - start)


def _traced(cell: Cell, runner) -> dict:
    """``trace_iters`` iterations under ``torch.profiler``: the device's
    activity and the host's ``aten`` operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark import yardstick

    n = int(cell.traffic.get("trace_iters", DEFAULT_TRACE_ITERS))
    on_card = torch.device(runner.prog.device).type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    first = runner.i
    with profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(n):
            runner.iteration(timed=False)
            runner.sync()
        span = time.perf_counter() - start
    # after the profiler: a copy back to the host must not show in it
    runner.after()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("aten::"):
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name()))
    if on_card and not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy = yardstick.union_s((a, b) for a, b, _ in device)
    return dict(n=n, span_s=span, busy_s=busy, device_events=device,
                host_events=host, spans=runner.spans,
                indices=range(first, first + n),
                breakdown={"device_ops": yardstick.device_ops(device),
                           "idle_gaps": yardstick.idle_gaps(device, host)})


def _captures(cell: Cell, runner, indices) -> dict:
    """The readers' captures of the traced iterations: the same
    iterations run again, untraced, under the readers' wraps, after the
    memory's peak is read.  A reader's ``keep`` may synchronize here, and
    keeps numbers only."""
    wraps = _Wraps(cell.readers)
    if wraps.items:
        with wraps:
            runner.replay(indices)
    return wraps.captures


def main(argv=None, t0: float | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out, lines = run(args.workload, args.seed, args.seconds,
                         bool(args.trace), root=root, t0=t0)
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    found = jax_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0

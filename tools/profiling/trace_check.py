"""Checks of the port's spans and counters (c_raytracer_tpu_torch/core/
tracing.py) on the card, in the benchmark's cells (BENCHMARK.json), each
cell's iterations run by the benchmark's own runner:

1. syncs: one iteration under ``torch.cuda.set_sync_debug_mode("warn")``
   with the counters on; the synchronizing operations CUDA reports, by
   source line, against the program's ``sync.<site>`` counts;
2. clock and cost: ``--iters`` iterations under ``torch.profiler`` (CPU
   and CUDA), each program record against the profiler's ``crt.*`` event
   of the same span (matched by name, in order of start): the share within
   50 µs and the signed differences; the host seconds spent inside the
   spans' and counters' own code (profiler ranges included) against the
   iterations' host seconds; the device's idle split by layer
   (benchmark/program_spans.py), the launches and busy seconds an
   iteration (launches and busy seconds alone without core/tracing.py);
3. cost on: ``--pairs`` profiler sessions, each a warm-up iteration and
   then two iterations, one with the spans and counters on and one with
   them held off, in alternating order: host seconds of each; and the
   host microseconds of an empty span under the profiler.

    python3 tools/profiling/trace_check.py [--cells A,B] [--seed N]
        [--iters 3] [--pairs 3] [--tree DIR]

``--tree DIR`` runs another checkout's port and benchmark (a checkout
without core/tracing.py runs step 1 without counters only).  Prints one
JSON line a cell.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import types
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("spheres1024.frame", "glass32.frame", "spheres512.step",
         "spheres1024.gi4")
WITHIN_NS = 50_000
SYNC_TEXT = "synchronizing CUDA operation"


def _tracing():
    try:
        from c_raytracer_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing


def runner_of(root, name, seed):
    from benchmark import core
    cell = core.cell_of(core.load_spec(root), name, False, root)
    run = cell.runner.Runner(cell, seed, "cuda", {})
    run.setup()
    run.sync()
    return run


def sync_census(run, tracing) -> dict:
    """One iteration: CUDA's synchronizing operations by source line, and
    the program's sync counts."""
    import torch
    if tracing:
        tracing.reset()
        tracing.enable()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run.iteration(timed=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    run.sync()
    run.after()
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in got
        if SYNC_TEXT in str(w.message))
    out = {"cuda_syncs": sum(where.values()), "sites": dict(where)}
    if tracing:
        tracing.disable()
        counts = tracing.totals()
        out["host_syncs"] = sum(v for k, v in counts.items()
                                if k.startswith("sync."))
        out["counters"] = counts
        tracing.reset()
    return out


def _events(prof):
    from torch.autograd import DeviceType
    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("aten::"):
                host.append((e.start_ns(), e.end_ns(), e.name()))
            elif e.name().startswith("crt."):
                spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name()))
    return device, host, spans


def _quantiles(xs) -> list:
    """Min, 1%, median, 99%, max of ``xs``."""
    xs = sorted(xs)
    n = len(xs)
    return [xs[int(q * (n - 1))] for q in (0, 0.01, 0.5, 0.99, 1)] if n \
        else None


def clock_check(recs, spans) -> dict:
    """Each record against the profiler's event of its span: the worse of
    its two ends, and the signed differences (record minus event) at the
    start and at the end."""
    by_rec, by_ev = collections.defaultdict(list), collections.defaultdict(
        list)
    for r in recs:
        by_rec[r.name].append((r.start, r.end))
    for a, b, name in spans:
        by_ev[name].append((a, b))
    diffs, d0, d1, unmatched = [], [], [], 0
    for name in set(by_rec) | set(by_ev):
        rs, es = sorted(by_rec[name]), sorted(by_ev[name])
        unmatched += abs(len(rs) - len(es))
        for r, e in zip(rs, es):
            d0.append(r[0] - e[0])
            d1.append(r[1] - e[1])
            diffs.append(max(abs(d0[-1]), abs(d1[-1])))
    n = len(diffs)
    return {"records": len(recs), "events": len(spans), "matched": n,
            "unmatched": unmatched,
            "within_50us": (sum(d <= WITHIN_NS for d in diffs) / n
                            if n else None),
            "worse_end_ns": _quantiles(diffs),
            "start_ns": _quantiles(d0), "end_ns": _quantiles(d1)}


class _SelfTime:
    """While open, the host nanoseconds spent in the spans' ``__enter__``
    and ``__exit__`` and in ``count`` add up in ``ns``."""

    def __init__(self, tracing):
        self.tracing, self.ns = tracing, 0

    def _timed(self, fn):
        clock = time.perf_counter_ns

        def inner(*args):
            t = clock()
            try:
                return fn(*args)
            finally:
                self.ns += clock() - t
        return inner

    def __enter__(self):
        tr = self.tracing
        self.real = (tr._Span.__enter__, tr._Span.__exit__, tr.count)
        tr._Span.__enter__, tr._Span.__exit__, tr.count = map(self._timed,
                                                               self.real)
        return self

    def __exit__(self, *exc):
        tr = self.tracing
        tr._Span.__enter__, tr._Span.__exit__, tr.count = self.real


def traced(run, tracing, iters: int) -> dict:
    """``iters`` iterations under the profiler, as the benchmark traces:
    the clock check, tracing's own host seconds, the idle split, launches
    and busy seconds."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import yardstick
    if tracing:
        tracing.reset()
    own = _SelfTime(tracing) if tracing else contextlib.nullcontext()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, own:
        t0 = time.perf_counter()
        for _ in range(iters):
            run.iteration(timed=False)
            run.sync()
        span_s = time.perf_counter() - t0
    run.after()
    device, host, spans = _events(prof)
    del prof
    torch.cuda.synchronize()
    out = {"span_s": span_s,
           "busy_s": yardstick.union_s((a, b) for a, b, _ in device),
           "launches_per_iter": len(device) / iters}
    if not tracing:
        return out
    from benchmark import program_spans
    recs = tracing.records()
    ctx = dict(iteration="frame", n=iters, device_events=device,
               host_events=host)
    out.update(clock=clock_check(recs, spans),
               tracing_s=own.ns / 1e9, tracing_share=own.ns / 1e9 / span_s,
               idle_split=program_spans.idle_split(ctx),
               spans_per_iter=len(recs) / iters,
               counts_per_iter={k: v / iters
                                for k, v in tracing.totals().items()})
    tracing.reset()
    return out


def cost_on(run, tracing, pairs: int) -> dict:
    """Host seconds of iterations under the profiler with the spans and
    counters on, and held off: each pair in a profiler session of its own
    after a warm-up iteration, the order alternating from pair to pair;
    and an empty span's host microseconds under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    real = tracing._profiler
    held = types.SimpleNamespace(_is_profiler_enabled=False)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    on, off = [], []
    for k in range(pairs):
        with profile(activities=acts):
            run.iteration(timed=False)
            run.sync()
            for spans_on in ((True, False) if k % 2 == 0 else (False, True)):
                tracing._profiler = real if spans_on else held
                try:
                    t0 = time.perf_counter()
                    run.iteration(timed=False)
                    run.sync()
                    (on if spans_on else off).append(
                        time.perf_counter() - t0)
                finally:
                    tracing._profiler = real
        run.after()
        tracing.reset()
    n = 20_000
    with profile(activities=acts):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("round", index=0):
                tracing.count("rounds")
        span_us = (time.perf_counter() - t0) / n * 1e6
    tracing.reset()
    return {"on_s": on, "off_s": off,
            "cost": sum(on) / sum(off) - 1.0, "span_us": span_us}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2147483647)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tracing = _tracing()
    for name in args.cells.split(","):
        t0 = time.perf_counter()
        run = runner_of(root, name, args.seed)
        out = {"cell": name, "tree": root,
               "syncs": sync_census(run, tracing)}
        if args.iters:
            out["traced"] = traced(run, tracing, args.iters)
        if tracing and args.pairs:
            out["cost_on"] = cost_on(run, tracing, args.pairs)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())

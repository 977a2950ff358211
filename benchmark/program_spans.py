"""The program's own spans and counters in a traced window, for the
readers of ``metrics/`` that take them from the program
(``c_raytracer_tpu_torch/core/tracing.py``) rather than from outside it.

While ``torch.profiler`` records, the program keeps a record of each span
(name, layer, parent, thread, start and end on the profiler's host clock,
the counts made while it was the innermost span).  The traced window runs
from the first to the last host operation in ``ctx["host_events"]``; the
records that overlap it are the window's (the set-up and the readers'
untraced replay run without a profiler, so the program keeps none there).
A program without the module, or a run without a trace, gives None, and
the readers then report nothing.
"""

from __future__ import annotations

import heapq

OUTSIDE = "outside program spans"


def window_records(ctx):
    """The program's records that overlap the traced window, or None."""
    try:
        from c_raytracer_tpu_torch.core import tracing
    except ImportError:
        return None
    host = ctx.get("host_events")
    if not host:
        return None
    w0 = min(a for a, _, _ in host)
    w1 = max(b for _, b, _ in host)
    recs = [r for r in tracing.records()
            if r.end is not None and r.start < w1 and r.end > w0]
    return recs or None


def counted(ctx, keep) -> float | None:
    """The sum of the window's counts whose names ``keep`` accepts, an
    iteration, or None without records."""
    recs = window_records(ctx)
    if recs is None:
        return None
    return sum(v for r in recs for k, v in r.counts.items()
               if keep(k)) / ctx["n"]


def innermost_layers(recs, times):
    """For each of the ascending ``times`` (ns), the layer of the span that
    was innermost (the latest to open of those open then) on the host, or
    ``OUTSIDE``."""
    order = sorted(recs, key=lambda r: r.start)
    heap, i, out = [], 0, []
    for t in times:
        while i < len(order) and order[i].start <= t:
            heapq.heappush(heap, (-order[i].start, i))
            i += 1
        while heap and order[heap[0][1]].end <= t:
            heapq.heappop(heap)
        out.append(order[heap[0][1]].layer if heap else OUTSIDE)
    return out


def idle_split(ctx) -> dict | None:
    """{layer: share of the device's idle seconds} over the traced window,
    summing to 1: each gap between the device's activity intervals (as
    ``yardstick.idle_gaps`` measures them) goes to the layer of the span
    innermost on the host when the gap ended.  None without records or
    without a gap."""
    device = ctx.get("device_events")
    if not device:
        return None
    recs = window_records(ctx)
    if recs is None:
        return None
    gaps, end = [], None
    for a, b in sorted((a, b) for a, b, _ in device):
        if end is not None and a > end:
            gaps.append((a, a - end))
        end = b if end is None else max(end, b)
    total = sum(g for _, g in gaps)
    if not total:
        return None
    split: dict = {}
    layers = innermost_layers(recs, [a for a, _ in gaps])
    for layer, (_, g) in zip(layers, gaps):
        split[layer] = split.get(layer, 0) + g / total
    return split


def idle_share(ctx, layer: str) -> float | None:
    """The share of the window's idle seconds put down to ``layer``."""
    split = idle_split(ctx)
    if split is None:
        return None
    return split.get(layer, 0.0)


def span_seconds(ctx, name: str) -> float | None:
    """The host seconds covered by the window's spans called ``name``
    (overlaps once, so nested spans count once), an iteration."""
    recs = window_records(ctx)
    if recs is None:
        return None
    total, end = 0, None
    for a, b in sorted((r.start, r.end) for r in recs if r.name == name):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9 / ctx["n"]

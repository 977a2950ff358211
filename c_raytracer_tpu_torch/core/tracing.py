"""Spans and counters at the port's layer boundaries.

``span(name, **attrs)`` marks a region of the program: the entry's frames
and tiles, the integrator's rounds, intersection, shading, GI samples, the
backward's recomputes and the collectives.  ``count(name, n)`` adds to a
host counter of the innermost open span: host reads of device values
(``sync.<site>``), rounds, union visit steps and blocks, GI samples, kernel
calls (``kernel.<name>``), collectives.  A counter never reads a device
value: each is a number the host already holds.

Tracing is on while a torch profiler records, or after ``enable()``.  Off,
``span`` costs one flag check and returns a shared no-op context, and
``count`` returns at once.  On, a span opens a profiler range named
``crt.<name>`` (so it shows in any exported trace, around the device work
it issued) and keeps a ``Record``: name, layer, id, parent id, thread,
frame number, start and end on the profiler's host clock (the Unix clock
in nanoseconds, as ``torch.profiler``'s events), attributes and the counts
made while it was the innermost span.  Counts made with no span open are
kept apart (``totals``).  Each thread has its own stack of open spans: on
the card autograd runs the backward, and so the recomputes, on a thread
of its own.

``records()`` returns the kept records, ``reset()`` drops them.  The layer
of a span is its name's first part, by ``LAYERS``; an idle gap of the
device is put down to the layer of the span that was innermost on the
host when the gap ended (``benchmark/metrics/idle_in_intersect.frame.py``).
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

LAYERS = {"frame": "entry", "tile": "entry", "round": "integrator",
          "intersect": "intersect", "shade": "shade", "gi": "gi",
          "remat": "backward", "comm": "comm"}
PREFIX = "crt."

# the profiler's range: the C++ form of ``torch.profiler.record_function``,
# which enters no dispatcher op (the selective-checkpoint contexts of
# core/remat.py line up the ops they see) and costs ~2 µs instead of ~15
_range = torch._C._profiler._RecordFunctionFast
_now = time.time_ns          # the clock of the profiler's host events

_on = False
_records: list = []
_loose: dict = {}            # counts made with no span open, any thread's
_loose_lock = threading.Lock()
_frame = 0
_ids = itertools.count(1)
_local = threading.local()
_names: dict = {}            # span name -> (range name, layer)


class Record:
    """One span: where it sits, when it ran, what it counted."""

    __slots__ = ("name", "layer", "id", "parent", "thread", "frame",
                 "start", "end", "attrs", "counts")


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "rng", "rec")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _frame
        full, layer = _names.get(self.name) or _name(self.name)
        self.rng = _range(full)
        self.rng.__enter__()
        # the clock next to the profiler's own reading, before anything
        # that allocates (and so may start a garbage collection)
        start = _now()
        stack = _stack()
        if self.name == "frame":
            _frame += 1
        rec = self.rec = Record()
        rec.name, rec.layer, rec.id = full, layer, next(_ids)
        rec.parent = stack[-1].id if stack else None
        rec.thread, rec.frame = threading.get_ident(), _frame
        rec.attrs, rec.counts = self.attrs, {}
        rec.start, rec.end = start, None
        stack.append(rec)
        _records.append(rec)
        return rec

    def __exit__(self, *exc):
        _stack().pop()
        self.rec.end = _now()
        self.rng.__exit__(*exc)
        return False


def _name(name: str):
    out = _names[name] = (PREFIX + name, LAYERS[name.split(".", 1)[0]])
    return out


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def enabled() -> bool:
    """Whether spans and counters record now."""
    return _on or _profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context over the region ``name`` (``"round"``, ``"intersect.
    closest"``; the first part names its layer, ``LAYERS``)."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """A decorator: each call of the function runs in ``span(name)``."""
    def wrap(fn):
        def inner(*args, **kwargs):
            if not (_on or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        inner.__name__, inner.__doc__ = fn.__name__, fn.__doc__
        inner.__qualname__, inner.__wrapped__ = fn.__qualname__, fn
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host number) to the counter ``name`` of the innermost
    open span."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    stack = getattr(_local, "stack", None)
    if stack:   # the thread's own span
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
        return
    with _loose_lock:
        _loose[name] = _loose.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def records() -> list:
    """The kept records, in the order their spans opened."""
    return list(_records)


def reset() -> None:
    """Drop the kept records and counts."""
    global _frame
    _records.clear()
    _loose.clear()
    _frame = 0


def totals(recs=None) -> dict:
    """Each counter summed over ``recs`` (by default every kept record and
    the counts made with no span open)."""
    out: dict = {}
    parts = [r.counts for r in (_records if recs is None else recs)]
    if recs is None:
        parts.append(_loose)
    for counts in parts:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out

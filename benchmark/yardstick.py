"""The benchmark's frozen arithmetic: the card's published peaks, the work
each kernel's call needs, and the device's busy share from a trace.

Copied so that a change to the program cannot move the yardstick:

* the peaks, ``bound_s``, kernel 2's ``FUSED_PER_SAMPLE``,
  ``FUSED_OPS_PER_SPHERE`` / ``_PLANE`` and ``fused_bound``, and kernel 3's
  ``VISIT_OPS_PER_BOX`` and its byte count: ``chip_smoke.py`` at commit
  4b67b239346d88fdce7ad88edd73510a597dff45 (``bound_ms``, ``fused_bound``,
  the ``bound_ms(...)`` arguments of its visit-order time lines).  The
  weights of a ``sinf``, ``powf`` and division are the ones its phase 10
  measured with the roofline probes on an NVIDIA H100 80GB HBM3 at 700 W
  (53.13, 159.61 and 35.74 float32 operations), frozen here rather than
  measured again in every run;
* the busy and idle share: ``tools/profiling/torch_frame_profile.py`` at
  commit 694e4f32d3542afbd28a1a741e5fe3a3ad888930 (``1 - busy / wall``),
  with busy taken as the union of the device's activity intervals, so that
  overlapping kernels count once.
"""

from __future__ import annotations

import bisect

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
VISIT_OPS_PER_BOX = 25      # kernel 3: the slab test of one box
FUSED_PER_SAMPLE = {"plain": 79, "sin": 4, "sqrt": 2, "div": 2, "pow": 1}
FUSED_OPS_PER_SPHERE = 30   # kernel 2: each occluding sphere a sample
FUSED_OPS_PER_PLANE = 25    # and each plane
OP_WEIGHTS = {"sqrt": 4, "sin": 53.13, "div": 35.74, "pow": 159.61}


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time for the work: bytes over the memory rate or float
    operations over the float32 rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def fused_bound_s(samples: int, P: int, live: int, n_scal: int, ns: int,
                  npl: int) -> float:
    """Kernel 2 on one chunk: ``samples`` live samples of ``live`` of P
    pixels against ``ns`` spheres (the emitter among them) and ``npl``
    planes.  Bytes: the live samples' uniforms, the okf row, the live
    pixels' other 16 rows, the scene scalars, the (3, P) output."""
    need = 4 * (2 * samples + P + 16 * live + n_scal + 3 * P)
    per = FUSED_PER_SAMPLE["plain"] + sum(
        n * OP_WEIGHTS[k] for k, n in FUSED_PER_SAMPLE.items()
        if k != "plain")
    occluders = FUSED_OPS_PER_SPHERE * (ns - 1) + FUSED_OPS_PER_PLANE * npl
    return bound_s(need, samples * (per + occluders))


def visit_bound_s(R: int, K: int, V: int, live: int) -> float:
    """Kernel 3 on one call: the slab test of ``live`` of R rays against K
    boxes and the V nearest kept.  Bytes: rays and boxes read once, the
    (R, V) ids and entries and the (R,) spill written once.  A call above
    256 slots runs in passes; its work is counted once."""
    return bound_s(4 * (6 * R + 6 * K + 2 * R * V + R),
                   VISIT_OPS_PER_BOX * live * K)


def union_s(intervals) -> float:
    """Seconds covered by (start_ns, end_ns) intervals, overlaps once."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def idle_gaps(device, host, top: int = 10):
    """The device's idle gaps between its first and last activity, summed
    by the host operation that was issuing when each gap ended (the last
    one to start before it).  ``device`` and ``host`` hold (start_ns,
    end_ns, name).  Returns [[name, seconds], ...], longest first."""
    spans = sorted((a, b) for a, b, _ in device)
    host = sorted(host)
    starts = [h[0] for h in host]
    by_name: dict = {}
    end = None
    for a, b in spans:
        if end is not None and a > end:
            i = bisect.bisect_right(starts, a) - 1
            name = host[i][2] if i >= 0 else "(none)"
            by_name[name] = by_name.get(name, 0.0) + (a - end) / 1e9
        end = b if end is None else max(end, b)
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:top]


def device_ops(device, top: int = 10):
    """The device operations with the most time: [[name, seconds], ...]."""
    by_name: dict = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    return sorted(([k[:160], v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:top]

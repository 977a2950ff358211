"""k3_visit_order_roofline: kernel 3 (``accel/pallas_visit.py`` →
``csrc/visit_order.cu``) over the traced window, in % of its bound: the
sum of each call's bound (``yardstick.visit_bound_s``: R rays, K boxes, V
slots, the rays with finite origin and direction live) over the sum of
the device time of its kernels in the trace.  The calls are captured by
wrapping ``visit_order`` while the harness runs the traced iterations
again untraced; only counts are kept.  A call above 256 slots runs in
passes and is counted once for the work it needs."""

import torch

from benchmark import yardstick

KERNEL = "visit_order_kernel"


def _keep(o, d, lo, hi, V, count_max_dist=None):
    live = int((torch.isfinite(o).all(1) & torch.isfinite(d).all(1)).sum())
    return int(o.shape[0]), int(lo.shape[0]), int(V), live


WRAPS = [("c_raytracer_tpu_torch.accel.pallas_visit", "visit_order", _keep)]


def read(ctx):
    seconds = sum(b - a for a, b, name in ctx.get("device_events", ())
                  if KERNEL in name) / 1e9
    if not ctx.get("calls") or seconds <= 0:
        return None
    bound = sum(yardstick.visit_bound_s(R, K, V, live)
                for R, K, V, live in ctx["calls"])
    return 100.0 * bound / seconds

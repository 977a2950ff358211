"""k2_fused_shadow_roofline: kernel 2 (``render/fused_shadow.py`` →
``csrc/fused_shadow.cu``) over the traced window, in % of its bound: the
sum of each call's bound (``yardstick.fused_bound_s``, from the call's
shapes and live samples) over the sum of the device time of its kernels
in the trace.  The calls are captured by wrapping ``fused_chunk`` where
its callers look it up, while the harness runs the traced iterations
again untraced; each call's live pixels are counted then, and only the
counts are kept."""

from benchmark import yardstick

KERNEL = "fused_shadow_kernel"


def _keep(u, px, scal_f, n_valid, *, lc, ns, npl, **_):
    live = int((px[16] > 0).sum())
    return (live, int(px.shape[1]), int(n_valid), int(lc),
            int(scal_f.numel()), int(ns), int(npl))


WRAPS = [("c_raytracer_tpu_torch.render.fused_shadow", "fused_chunk",
          _keep)]


def read(ctx):
    seconds = sum(b - a for a, b, name in ctx.get("device_events", ())
                  if KERNEL in name) / 1e9
    if not ctx.get("calls") or seconds <= 0:
        return None
    bound = sum(yardstick.fused_bound_s(live * min(lc, n_valid), P, live,
                                        n_scal, ns, npl)
                for live, P, n_valid, lc, n_scal, ns, npl in ctx["calls"])
    return 100.0 * bound / seconds

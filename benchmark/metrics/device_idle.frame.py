"""device_idle.frame: 1 − the union of the device's activity intervals in
the trace over the traced frames' seconds on the host's clock (at least
three whole frames, each ending in a synchronize)."""


def read(ctx):
    if ctx["iteration"] != "frame" or "busy_s" not in ctx:
        return None
    return 1.0 - ctx["busy_s"] / ctx["span_s"]

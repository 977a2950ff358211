"""device_idle.step: 1 − the union of the device's activity intervals in
the trace over the traced steps' seconds on the host's clock (at least
three whole steps, each ending in a synchronize)."""


def read(ctx):
    if ctx["iteration"] != "step" or "busy_s" not in ctx:
        return None
    return 1.0 - ctx["busy_s"] / ctx["span_s"]

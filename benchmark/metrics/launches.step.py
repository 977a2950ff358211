"""launches.step: the device operations (kernels, copies, fills) that the
profiler records over the traced steps, a step."""


def read(ctx):
    if ctx["iteration"] != "step" or "device_events" not in ctx:
        return None
    return len(ctx["device_events"]) / ctx["n"]

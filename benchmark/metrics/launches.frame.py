"""launches.frame: the device operations (kernels, copies, fills) that the
profiler records over the traced frames, a frame."""


def read(ctx):
    if ctx["iteration"] != "frame" or "device_events" not in ctx:
        return None
    return len(ctx["device_events"]) / ctx["n"]

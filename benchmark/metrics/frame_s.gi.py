"""frame_s.gi: the traced frames' seconds on the host's clock over the
frames, in the cells whose frame time is not held end to end (path GI:
from machine to machine the host's speed spreads its windows past the
largest bound).  Under the profiler, which slows the host; it moves
``setup_s`` through the warm-up frame."""


def read(ctx):
    if ctx["iteration"] != "frame" or "span_s" not in ctx:
        return None
    return ctx["span_s"] / ctx["n"]

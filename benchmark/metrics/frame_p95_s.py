"""frame_p95_s: the 95th percentile of every frame's seconds in the
window (each frame timed from its call to its synchronize)."""

import statistics


def read(ctx):
    times = ctx.get("times")
    if ctx["iteration"] != "frame" or not times or len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]

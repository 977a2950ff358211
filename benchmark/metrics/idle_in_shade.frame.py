"""idle_in_shade.frame: ``idle_in_intersect.frame``, read alike, for the
layer ``shade`` (``crt.shade.*``: each emitter's direct light and each
light chunk, kernel 2's calls among them)."""

import os

from benchmark import core

_SAME = core.reader(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "idle_in_intersect.frame")


def read(ctx):
    return _SAME.share(ctx, "shade")

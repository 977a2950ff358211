"""union_steps.frame: the union shadow sweep's visit steps (the program's
``union_steps`` counter, ``c_raytracer_tpu_torch/core/tracing.py``: the
slot loop of ``accel/traverse.py`` ``any_hit_tint_shared`` on the union
route) over the traced frames, a frame.  Beside ``launches.frame`` it
gives the launches a visit step."""

from benchmark import program_spans


def read(ctx):
    if ctx["iteration"] != "frame":
        return None
    return program_spans.counted(ctx, lambda k: k == "union_steps")

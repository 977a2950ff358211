"""host_syncs.frame: the program's host reads of device values (its
``sync.<site>`` counters, ``c_raytracer_tpu_torch/core/tracing.py``) over
the traced frames, a frame."""

from benchmark import program_spans


def read(ctx):
    if ctx["iteration"] != "frame":
        return None
    return program_spans.counted(ctx, lambda k: k.startswith("sync."))

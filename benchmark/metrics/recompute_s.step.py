"""recompute_s.step: the host's seconds inside the program's
``crt.remat.recompute`` spans (``c_raytracer_tpu_torch/core/tracing.py``;
whole spans, nested ones once, under the profiler) over the traced steps,
a step: the backward's recomputes of rounds, light chunks and GI
samples.  Read it beside ``bwd_s.step``."""

from benchmark import program_spans


def read(ctx):
    if ctx["iteration"] != "step":
        return None
    return program_spans.span_seconds(ctx, "crt.remat.recompute")

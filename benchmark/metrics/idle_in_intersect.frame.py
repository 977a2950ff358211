"""idle_in_intersect.frame: the share of the device's idle seconds in the
traced frames whose gap ended while the host's innermost open span of the
program (``c_raytracer_tpu_torch/core/tracing.py``) was of the layer
``intersect`` (``crt.intersect.*``: closest hit, re-test, shadow queries,
union sweep blocks).  Gaps lie between the device's activity intervals,
as ``yardstick.idle_gaps`` measures them (``program_spans.idle_split``)."""

from benchmark import program_spans


def share(ctx, layer: str):
    """The traced frames' idle share of ``layer``, or None."""
    if ctx["iteration"] != "frame":
        return None
    return program_spans.idle_share(ctx, layer)


def read(ctx):
    return share(ctx, "intersect")

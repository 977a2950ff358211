"""bwd_s.step: the host's seconds around ``loss.backward()`` and a
synchronize, summed over the traced steps, a step."""


def read(ctx):
    spans = ctx.get("spans", {}).get("backward")
    if ctx["iteration"] != "step" or not spans:
        return None
    return sum(spans) / ctx["n"]

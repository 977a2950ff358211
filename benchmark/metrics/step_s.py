"""step_s: the window's seconds over the gradient steps completed in
it."""


def read(ctx):
    if ctx["iteration"] != "step" or "window_s" not in ctx:
        return None
    return ctx["window_s"] / ctx["n"]

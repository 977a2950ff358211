"""frame_s: the window's seconds over the frames completed in it."""


def read(ctx):
    if ctx["iteration"] != "frame" or "window_s" not in ctx:
        return None
    return ctx["window_s"] / ctx["n"]

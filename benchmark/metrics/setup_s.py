"""setup_s: seconds from the process's start to the window's: imports,
the kernels' build or load, the scene, the renderer, the warm-up."""


def read(ctx):
    return ctx["setup_s"]

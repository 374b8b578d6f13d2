"""Process start to the window's start: imports, CUDA, kernel libraries,
weights, warm-up and (serving) the preroll."""


def read(ctx):
    return ctx["setup_s"]

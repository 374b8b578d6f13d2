"""Samples of every step issued inside the window, over the window's
seconds (the window ends after a synchronise)."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["samples"] / ctx["window_s"]

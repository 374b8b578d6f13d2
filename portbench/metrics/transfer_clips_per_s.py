"""Clips answered inside the window (image and 3 s WAV each), over the
window's seconds."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return ctx["completed"] / ctx["window_s"]

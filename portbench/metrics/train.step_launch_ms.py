"""The LDM step as the host issues it: mean ms from the start of its
``train.draws`` to the end of its ``train.optimizer``, from the program's
own spans (a step counts where both lie in the window and off the
profiled sub-window)."""
import numpy as np

from portbench.program import inside


def read(ctx):
    p = ctx.get("program")
    if not p:
        return None
    steps, start = [], None
    for r in sorted(p["spans"], key=lambda r: r.start):
        if r.name == "train.draws":
            start = r.start
        elif r.name == "train.optimizer" and start is not None:
            if inside(p, start, r.end):
                steps.append(r.end - start)
            start = None
    return 1e3 * float(np.mean(steps)) if steps else None

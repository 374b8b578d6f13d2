"""Share of the dispatched buckets' slots that held a request: the
engine's own counters, ``stats()['rows_dispatched']`` over itself plus
``padded_slots``, over the whole run (preroll, window and drain).  None
where the engine keeps no such counter."""


def read(ctx):
    stats = ctx.get("stats") or {}
    rows = stats.get("rows_dispatched")
    if not rows:
        return None
    return rows / (rows + stats["padded_slots"])

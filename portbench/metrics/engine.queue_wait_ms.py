"""Mean time a request waited in the engine's queue, from ``submit`` to
the dispatch thread taking it: the engine's own counters
(``stats()['queue_wait_s_total']`` over ``queue_waits``, the requests
the dispatch thread took), over the whole run (preroll, window and
drain).  None where the engine keeps no such counter."""


def read(ctx):
    stats = ctx.get("stats") or {}
    waits = stats.get("queue_waits")
    if not waits or "queue_wait_s_total" not in stats:
        return None
    return 1000.0 * stats["queue_wait_s_total"] / waits

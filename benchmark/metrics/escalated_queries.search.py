"""escalated_queries.search: per request of the measured window, the queries that the
port's certified search sent to a second pass over a slab (``certified_topk``'s counter
``escalated_queries``, summed over the slabs). The search's work beyond the first pass
follows it, and so does its time."""


def read(run):
    units = run.counters.get("units")
    if not units or run.counters.get("escalated") is None:
        return None
    return run.counters["escalated"] / units

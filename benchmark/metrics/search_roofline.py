"""search_roofline: the exact searches' least time (``harness.roofline.flat_search_bound_s``,
fixed by the rows, the width, the queries and the mode, not by the kernels that run) over
the device seconds of the operations launched inside the benchmark's ``search`` spans of
the traced window (its requests: ``run.trace_counters``): the search layer's share of its
roofline."""

from harness.roofline import flat_search_bound_s, model_dims


def read(run):
    lens = run.trace_counters.get("query_lengths")
    busy = run.trace.get("span_device_s", {}).get("search")
    if not lens or not busy:
        return None
    tr = run.traffic
    H = model_dims(run.config)[1]
    least = sum(flat_search_bound_s(tr["corpus_rows"], H, len(q), 1.0) for q in lens)
    return 100.0 * least / busy

"""mfu.search: the least time of the measured (untraced) window's requests over its seconds
on the host clock, as a share. A request's least time: its queries' tower forward (real
tokens) at the bf16 peak, plus the exact search's bound
(``harness.roofline.flat_search_bound_s``: the 2 N H Q products at the bf16 peak, or the
int8 rows, scales and queries read once)."""

from harness.roofline import PEAK_OPS_S, flat_search_bound_s, lengths_flops, model_dims


def read(run):
    lens = run.counters.get("query_lengths")
    if not lens or not run.window_s:
        return None
    tr = run.traffic
    H = model_dims(run.config)[1]
    least = lengths_flops(run.config, lens) / PEAK_OPS_S["bf16"] + sum(
        flat_search_bound_s(tr["corpus_rows"], H, len(q), 1.0) for q in lens)
    return 100.0 * least / run.window_s

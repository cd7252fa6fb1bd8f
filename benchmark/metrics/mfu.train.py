"""mfu.train: three times the forward FLOPs of the measured (untraced) window's training
steps (both towers' real tokens, plus the in-batch loss's [Q, P] scores) over its seconds
on the host clock, as a share of the H100's bf16 peak. The backward counts twice the
forward; no recompute is counted."""

from harness.roofline import PEAK_OPS_S, contrastive_flops, lengths_flops, model_dims


def read(run):
    q, p = run.counters.get("train_query_lengths"), run.counters.get("train_passage_lengths")
    if not q or not run.window_s:
        return None
    H = model_dims(run.config)[1]
    loss = sum(contrastive_flops(len(a), len(b), H) for a, b in zip(q, p))
    flops = 3.0 * (lengths_flops(run.config, q) + lengths_flops(run.config, p) + loss)
    return 100.0 * flops / (run.window_s * PEAK_OPS_S["bf16"])

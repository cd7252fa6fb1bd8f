"""Bucketed vs always-padded bert-base encode over a variable-length corpus.

Twin of the JAX package's ``recipes/varlen_probe.py``, on ``bench_encode_varlen``'s
workload (bench.py:1340 there): 16,384 passages of lognormal length (median ~70
tokens, clipped to [16, 156]) drawn by ``np.random.default_rng(0)``, in batches of
256, encoded padded to 156 and, sorted by length, padded to their 32-token bucket
(``data/collators.py:pad_batch(..., bucket_step=32)``). It prints the bucket
widths' batch counts, the padded-token ceiling and three fixed-vs-bucketed trials
(passages/s on the host clock, ended by a synchronize), as the JAX file does.
``--attention`` defaults to 'xla' (``_bert_base_model``'s default); 'fused'
(``bench_encode_varlen_fused``, bench.py:1398) runs K1 / K2. ``--trials`` sets the
repeats.

    python -m denseretrievaltoolkits_torch.recipes.varlen_probe [--attention fused]

:func:`main` also holds the two arms' pooled reps to each other (each passage's
cosine, bucketed against padded) and returns the readings (:func:`trials`).
"""

from __future__ import annotations

import argparse
import time
from collections import Counter

import numpy as np
import torch

from . import bench_data as bd

MAXL = 156


def workload(vocab_size: int, n: int = 16384, batch: int = 256, bucket_step: int = 32):
    """(lengths, fixed batches, bucketed batches, the bucketed order): the JAX file's
    draws from ``default_rng(0)``."""
    from ..data.collators import pad_batch

    rng = np.random.default_rng(0)
    lens = np.clip(np.exp(rng.normal(4.25, 0.55, n)), 16, MAXL).astype(int)
    seqs = [rng.integers(1, vocab_size, L).tolist() for L in lens]
    fixed = [pad_batch(seqs[i:i + batch], MAXL, 0) for i in range(0, n, batch)]
    order = np.argsort(lens, kind="stable")
    sseqs = [seqs[i] for i in order]
    bucketed = [pad_batch(sseqs[i:i + batch], MAXL, 0, bucket_step=bucket_step)
                for i in range(0, n, batch)]
    return lens, fixed, bucketed, order


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--attention", default="xla", choices=("xla", "fused", "flash"))
    parser.add_argument("--trials", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from ..device import resolve_device

    device = resolve_device(args.device, "varlen_probe")
    config, model = bd.bert_base_model(args.attention, device)
    out = trials(model, *workload(config.vocab_size)[1:], args.trials, device)
    return dict(out, attention=args.attention)


def trials(model, fixed, bucketed, order, n_trials: int, device) -> dict:
    """The histogram, the ceiling and ``n_trials`` fixed-vs-bucketed trials of ``model``'s
    passage encode over the workload, printed as the JAX file prints them; then each
    passage's pooled-rep cosine, bucketed against padded."""
    N = int(sum(b["input_ids"].shape[0] for b in fixed))
    widths = Counter(int(b["input_ids"].shape[1]) for b in bucketed)
    print(f"# bucket widths -> batch counts: {dict(sorted(widths.items()))}", flush=True)
    tok_fixed = sum(b["input_ids"].size for b in fixed)
    tok_buck = sum(b["input_ids"].size for b in bucketed)
    print(f"# padded tokens: fixed {tok_fixed} bucketed {tok_buck} "
          f"(ceiling {tok_fixed / tok_buck:.2f}x)", flush=True)

    def run(batches, tag):
        seen = set()
        t0 = time.perf_counter()
        for b in batches:  # one warm-up call of each shape, off the clock
            if b["input_ids"].shape not in seen:
                seen.add(b["input_ids"].shape)
                model.encode_passage(b)
        bd.sync(device)
        print(f"#   [{tag}] warm {len(seen)} shapes in {time.perf_counter() - t0:.1f}s",
              flush=True)
        rt = bd.roundtrip(device)
        t0 = time.perf_counter()
        outs = [model.encode_passage(b) for b in batches]
        bd.sync(device)
        el = time.perf_counter() - t0 - rt
        print(f"#   [{tag}] {el:.2f}s on clock (rt {rt * 1e3:.0f} ms) -> {N / el:.0f} p/s",
              flush=True)
        return N / el, outs

    readings = []
    for trial in range(n_trials):
        pf, reps_fixed = run(fixed, f"t{trial} fixed")
        pb, reps_buck = run(bucketed, f"t{trial} bucketed")
        print(f"# trial {trial}: fixed {pf:.0f} bucketed {pb:.0f} ratio {pb / pf:.2f}x",
              flush=True)
        readings.append({"fixed": pf, "bucketed": pb, "ratio": pb / pf})
    a = torch.cat(reps_fixed).float()
    b = torch.empty_like(a)
    b[torch.from_numpy(order).to(a.device)] = torch.cat(reps_buck).float()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    print(f"# pooled reps, bucketed vs fixed: min cosine {float(cos.min()):.6f}", flush=True)
    return {"widths": dict(sorted(widths.items())), "tokens_fixed": int(tok_fixed),
            "tokens_bucketed": int(tok_buck), "trials": readings,
            "min_cosine": float(cos.min())}


if __name__ == "__main__":
    main()

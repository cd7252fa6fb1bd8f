#!/usr/bin/env python3
"""Drive the torch port's serving and training paths once on one CUDA card, and check them.

    python3 chip_smoke.py [--seed 0] [--passages 8192] [--out results.json]

Phases, each of which fails the run on error:

1. Build the hand-written kernels of ``denseretrievaltoolkits_torch/csrc``
   with nvcc (``_build/``, at first use) and print the build time.
2. Kernel vs plain version at the main paths' shapes: K1 (attention + LN) and
   K2 (MLP + LN) at bert-base widths, bf16 at B=64, S=156 (serving), B=256,
   S=128 and B=32, S=32 (training passages and queries), and fp32 at B=8;
   K5 (block top-J) on a 1,000,000 x 768 corpus, fp32 and bf16, 1024 queries,
   k=100, through the certified search against the exact scan.
3. The main path, through the entry points a user calls: a bert-base
   (12 layers, H=768, bf16, ``attention='fused'``) dual encoder with seeded
   random weights built by ``DRModelForInference.build``; ``encode_batches``
   over lognormal-length passages (S=156) and queries (S=32); a float32
   ``FlatIPIndex``; ``batch_search(k=100, mode='exact')``; docids, a ranking
   file and ``get_metrics``. Launch counters are zeroed just before and read
   just after; every kernel must have launched. K5 is then held to its plain
   version at this path's own shape. The same path runs again with the plain
   versions in place of the three kernels, and the two must agree.
4. K3 / K4 (fused contrastive loss and its gradient) vs their plain versions,
   fp32, H=768, stride 8: at grad-cache scale (Q=4096, P=32768), ragged
   (Q=1000, P=8000) and at the training path's shape (Q=32, P=256). Loss
   and grad errors, kernel vs plain ms (forward, and
   forward + backward), peak device memory of each path; plain variants with
   the target one column off, or without the 1/n_q, must fail the bounds.
5. The training main path, through the entry points a user calls: a bert-base
   (12 layers, H=768, bf16, ``attention='fused'``, ``fused_loss=True``, tied)
   built by ``DRModel.build`` from an architecture-only dir (seeded random
   init), trained by ``Trainer.train`` for 2 epochs of 6 steps (batch 32 x 8
   passages, q_max_len 32, p_max_len 128; adamw, linear schedule, warmup
   ratio 0.1) on synthetic batches through the shared ``DataLoader``.
   Launch counters of K1-K4 are zeroed just before and read just after; all
   must have launched, every loss be finite and the last epoch's mean loss
   below the first's. The same run with the plain versions must agree (step-1
   loss, step-1 gradient cosine and norm ratio, every step's loss). Then
   steps/s and tokens/s
   (kernels vs plain), the deploy-format save reloaded by
   ``DRModelForInference.build`` (same reps), and a checkpoint resume (the
   next step's loss equals the uninterrupted run's).

Prints the card's name and power limit, one JSON line of per-kernel results,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
when no CUDA card is present or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# The main path's FlatIPIndex block: 512 rows give the 8192-row index 16 blocks,
# so k=100 takes the K5 candidate path. The index's default 4096-row blocks would
# give it 2, whose 2 x J=8 candidates cannot hold k=100: the search would scan.
INDEX_BLOCK = 512
# Training path, kernels vs plain versions (bf16 towers, unnormalized CLS reps
# whose scores reach the hundreds, so bf16 roundings move the loss): bounds about
# 2x the readings on the H100 (step-1 loss rel 9.25e-3, step-1 gradient cosine
# 0.99857, largest step-loss gap 0.043 over 12 steps at lr 1e-5), which repeat
# from run to run.
TRAIN_STEP1_REL = 2e-2
TRAIN_GRAD_COS = 0.995
TRAIN_STEP_GAP = 0.1
# The cosine cannot see the gradient's scale (nor can AdamW's steps): the ratio
# of the step-1 gradient norms, kernels / plain, must lie within this of 1;
# about 2x the reading on the H100 (0.97995). A gradient off by n_q reads 32x.
TRAIN_GRAD_NORM = 4e-2
# The training path's run: bert-base at full depth, 32 queries x 8 passages per
# batch, 6 steps per epoch, 2 epochs, 6 timed steps. lr 1e-4 diverged from
# random init on the H100 (step-2 loss 15, then collapse to log 256); 1e-5 trains.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_STEPS_PER_EPOCH, TRAIN_LR, TRAIN_TIMED_STEPS = 12, 32, 6, 1e-5, 6


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=5, warmup=1):
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def certificate_counts(topk):
    """(escalated, fallback) query counts of the certified search so far."""
    return topk.certified_topk.escalated_queries, topk.certified_topk.fallback_queries


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def ragged_mask(gen, B, S, n_pad_rows):
    """Lognormal lengths in [1, S] with the last rows all padding."""
    lens = torch.exp(torch.randn(B, generator=gen, device="cuda") * 0.5 + math.log(S / 2.5))
    lens = lens.clamp(1, S).long()
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    mask[B - n_pad_rows:] = 0
    return mask


def phase_block_kernels(gen, attn):
    """K1 and K2 vs their plain versions at bert-base widths, at the serving
    path's shape (B=64, S=156) and the training path's (passages B=256, S=128;
    queries B=32, S=32)."""
    H, nh, hd, F = 768, 12, 64, 3072
    # bf16: post-LN outputs are O(1), 3e-2 is two bf16 ulps at |y| < 4; the mean
    # bound sits 14x above the readings (K2 7.3e-6) and below a residual added in
    # bf16 (the xla block's semantics). fp32: summation order.
    cases = [(torch.bfloat16, 64, 156, 3e-2, 1e-4), (torch.float32, 8, 156, 1e-4, 1e-5),
             (torch.bfloat16, 256, 128, 3e-2, 1e-4), (torch.bfloat16, 32, 32, 3e-2, 1e-4)]
    results = {}
    for dtype, B, S, tol_max, tol_mean in cases:
        def r(*shape, scale=1.0, dt=dtype):
            return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

        mask = ragged_mask(gen, B, S, n_pad_rows=2)
        ls, lb = 1 + r(H, scale=0.1, dt=torch.float32), r(H, scale=0.1, dt=torch.float32)
        k1 = (r(B, S, 3 * H), r(B, S, H), mask, r(H, H, scale=0.02), r(H, scale=0.02),
              ls, lb, 1 / math.sqrt(hd), nh, hd, 1e-12)
        k2 = (r(B, S, H), r(H, F, scale=0.02), r(F, scale=0.02), r(F, H, scale=0.02),
              r(H, scale=0.02), ls, lb, 1e-12)
        for name, fn, ref, args in (("K1", attn.fused_attention_ln, attn._reference_attention_ln, k1),
                                    ("K2", attn.fused_mlp_ln, attn._reference_mlp_ln, k2)):
            out = fn(*args)
            torch.cuda.synchronize()
            want = ref(*args)
            err = (out.float() - want.float()).abs()
            finite = bool(torch.isfinite(out).all())
            ms, plain_ms = cuda_ms(lambda: fn(*args)), cuda_ms(lambda: ref(*args))
            log(f"{name} {str(dtype)[6:]} B={B} S={S}: max_abs {err.max().item():.3e} "
                f"mean_abs {err.mean().item():.3e} (tol {tol_max:g}/{tol_mean:g}) finite={finite} "
                f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
            check(finite, f"{name} {dtype}: non-finite output")
            check(err.max().item() <= tol_max and err.mean().item() <= tol_mean,
                  f"{name} {dtype} B={B} S={S}: kernel disagrees with its plain version")
            results[f"{name} {str(dtype)[6:]} B={B} S={S}"] = {
                "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(), "ms": ms,
                "plain_ms": plain_ms}
    return results


def topk_errors(q, corpus, vals, ids, ref_vals):
    """Rank-wise score error of a top-k against its reference, and the error of
    its ids rescored in fp64 against the reference's scores: ids may differ from
    the reference's only inside near ties. Queries are cast to the corpus dtype,
    as the search does."""
    Q = q.shape[0]
    vals, ids, ref_vals = vals.reshape(Q, -1), ids.reshape(Q, -1), ref_vals.reshape(Q, -1)
    rescored = torch.einsum("qd,qkd->qk", q.to(corpus.dtype).double(),
                            corpus[ids.long()].double())
    return (vals - ref_vals).abs(), (rescored - ref_vals.double()).abs()


def phase_topk(gen, topk, blockwise_topk, n_rows, n_queries=1024, k=100, dim=768):
    """K5 through the certified search vs the exact scan on a seeded corpus."""
    results = {}
    for dtype, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
        corpus = torch.randn(n_rows, dim, generator=gen, device="cuda").to(dtype)
        q = torch.randn(n_queries, dim, generator=gen, device="cuda")
        block = 4096  # FlatIPIndex's rule (flat.py:334) at this size
        before = certificate_counts(topk)
        s, ids = topk.certified_topk(q, corpus, k, block)
        torch.cuda.synchronize()
        bs, bids = blockwise_topk(q, corpus, k, block)
        escalated, fallbacks = np.subtract(certificate_counts(topk), before).tolist()
        tol = rel_tol * bs.abs().clamp(min=1.0)
        rank_err, rescored_err = topk_errors(q, corpus, s, ids, bs)
        mismatched = int((ids != bids).sum())
        qc = q.to(dtype)
        ms = cuda_ms(lambda: topk.block_topj(qc, corpus, 8, block, n_rows), iters=3)
        plain_ms = cuda_ms(lambda: topk._block_topj_reference(qc, corpus, 8, block, n_rows), iters=3)
        search_ms = cuda_ms(lambda: topk.certified_topk(q, corpus, k, block), iters=3)
        scan_ms = cuda_ms(lambda: blockwise_topk(q, corpus, k, block), iters=3)
        log(f"K5 {str(dtype)[6:]} {n_rows}x{dim} Q={n_queries} k={k}: ids differing {mismatched} "
            f"of {ids.numel()}, max rank score err {rank_err.max().item():.3e}, max rescored err "
            f"{rescored_err.max().item():.3e} (rel tol {rel_tol:g}), certificate escalated "
            f"{escalated} fallbacks {fallbacks}; block_topj kernel {ms:.3f} ms plain "
            f"{plain_ms:.3f} ms; certified search {search_ms:.3f} ms exact scan {scan_ms:.3f} ms")
        check(bool((rank_err <= tol).all()), f"K5 {dtype}: scores disagree with the exact scan")
        check(bool((rescored_err <= tol.double()).all()), f"K5 {dtype}: ids are not the top-k")
        results[str(dtype)[6:]] = {"max_abs_err": rank_err.max().item(), "ms": ms,
                                   "plain_ms": plain_ms, "search_ms": search_ms,
                                   "scan_ms": scan_ms, "escalated": escalated,
                                   "fallbacks": fallbacks}
        del corpus
        torch.cuda.empty_cache()
    return results


def make_batches(rng, n, max_len, prefix, batch, pad_batch, docs=None):
    """Lognormal-length token sequences with [CLS]/[SEP]; queries (docs given)
    are prefixes of their passage, which makes passage i relevant to query i."""
    seqs = []
    for i in range(n):
        if docs is None:
            L = int(np.clip(rng.lognormal(math.log(60), 0.5), 8, max_len))
            seqs.append([101] + rng.integers(1000, 30522, L - 2).tolist() + [102])
        else:
            L = int(np.clip(rng.lognormal(math.log(10), 0.4), 4, max_len))
            seqs.append(docs[i][:L - 1] + [102])
    batches = [([f"{prefix}{j}" for j in range(s, min(s + batch, n))],
                pad_batch(seqs[s:s + batch], max_len, 0)) for s in range(0, n, batch)]
    return seqs, batches


def phase_main_path(args, tmp):
    from denseretrievaltoolkits_torch.evaluator.retrieval import (
        get_metrics, search_queries, write_ranking)
    from denseretrievaltoolkits_torch.index.flat import FlatIPIndex
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModelForInference
    from denseretrievaltoolkits_torch.ops import attn, topk
    from denseretrievaltoolkits_torch.run_encode import ModelArguments, encode_batches, pad_batch

    config = BertConfig(num_hidden_layers=args.layers)
    arch = os.path.join(tmp, "bert-base")
    save_config(config, arch)  # architecture-only dir: DRModel.build random-inits it
    model = DRModelForInference.build(
        ModelArguments(model_name_or_path=arch, dtype="bfloat16", attention="fused",
                       pooling="first"), device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    docs, p_batches = make_batches(rng, args.passages, 156, "d", args.batch, pad_batch)
    _, q_batches = make_batches(rng, args.queries, 32, "q", args.batch, pad_batch, docs=docs)
    n_tokens = sum(int(b["attention_mask"].sum()) for _, b in p_batches)
    log(f"main path: bert-base L={config.num_hidden_layers} H={config.hidden_size} bf16 fused; "
        f"{args.passages} passages (S=156, {n_tokens / args.passages:.1f} real tokens each), "
        f"{args.queries} queries (S=32), batch {args.batch}")

    def run(label, reps=None):
        """Encode (unless ``reps`` are given), index, search, rank, score."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if reps is None:
            p_reps, p_lookup = encode_batches(model, p_batches, "passage", args.batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q_reps, q_lookup = encode_batches(model, q_batches, "query", args.batch)
        else:
            (p_reps, p_lookup), (q_reps, q_lookup) = reps
            t1 = None
        index = FlatIPIndex(p_reps.shape[1], dtype="float32", block_size=INDEX_BLOCK,
                            device="cuda")
        index.add(p_reps)
        index.docid = list(p_lookup)
        index.search(q_reps[:1], args.k)  # uploads the corpus; not part of the search time
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores, docids = search_queries(index, q_reps, index.docid, args.k,
                                        batch_size=args.queries)
        t3 = time.perf_counter()
        ranking = os.path.join(tmp, f"ranking_{label}.tsv")
        write_ranking(docids, scores, q_lookup, ranking)
        hits = np.array([[d == f"d{q}" for d in row] for q, row in enumerate(docids)])
        metrics = {k: v / len(q_lookup) for k, v in get_metrics(hits, [1, 10, 100]).items()}
        with open(ranking) as fh:
            n_lines = sum(1 for _ in fh)
        out = dict(p_reps=(p_reps, p_lookup), q_reps=(q_reps, q_lookup), scores=np.asarray(scores),
                   docids=np.asarray(docids), metrics=metrics,
                   queries_per_s=len(q_lookup) / (t3 - t2), ranking_lines=n_lines)
        if t1 is not None:
            out["passages_per_s"] = len(p_lookup) / (t1 - t0)
        log(f"{label}: encode {out.get('passages_per_s', 0):.1f} passages/s, search "
            f"{out['queries_per_s']:.1f} queries/s (k={args.k}, {index.block_size}-row blocks), "
            f"ranking {n_lines} lines, metrics {json.dumps(metrics)}")
        check(p_reps.shape == (args.passages, config.hidden_size), f"{label}: passage reps shape")
        check(np.isfinite(p_reps).all() and np.isfinite(q_reps).all(), f"{label}: non-finite reps")
        check(n_lines == args.queries * args.k, f"{label}: ranking file length")
        return out

    counted = (attn.fused_attention_ln, attn.fused_mlp_ln, topk.block_topj)
    counts0 = certificate_counts(topk)
    for fn in counted:
        fn.launches = 0
    kern = run("kernels")
    launches = {fn.__name__: fn.launches for fn in counted}
    escalated, fallbacks = np.subtract(certificate_counts(topk), counts0).tolist()
    log(f"launches on the main path: {json.dumps(launches)}; certificate escalated queries "
        f"{escalated}, fallback queries {fallbacks}")
    check(all(n > 0 for n in launches.values()), "a kernel of the main path never launched")

    # K5 at the main path's own shape: the kernels' reps, the index's blocks and J
    q = torch.from_numpy(kern["q_reps"][0]).cuda()
    corpus = torch.from_numpy(kern["p_reps"][0]).cuda()
    J = max(4, min(args.k, 8))
    vals, ids = topk.block_topj(q, corpus, J, INDEX_BLOCK, corpus.shape[0])
    ref_vals, _ = topk._block_topj_reference(q, corpus, J, INDEX_BLOCK, corpus.shape[0])
    rank_err, rescored_err = topk_errors(q, corpus, vals, ids, ref_vals)
    tol = 1e-5 * ref_vals.reshape(q.shape[0], -1).abs().clamp(min=1.0)
    log(f"K5 float32 at the main path's shape ({q.shape[0]} x {tuple(corpus.shape)}, block "
        f"{INDEX_BLOCK}, J={J}): max rank score err {rank_err.max().item():.3e}, max "
        f"rescored err {rescored_err.max().item():.3e} (rel tol 1e-05)")
    check(bool((rank_err <= tol).all()) and bool((rescored_err <= tol.double()).all()),
          "K5 disagrees with its plain version at the main path's shape")

    with mock.patch.object(attn, "fused_attention_ln", attn._reference_attention_ln), \
            mock.patch.object(attn, "fused_mlp_ln", attn._reference_mlp_ln), \
            mock.patch.object(topk, "block_topj", topk._block_topj_reference):
        plain = run("plain")
        plain_search = run("plain search over the kernels' reps",
                           reps=(kern["p_reps"], kern["q_reps"]))

    def overlap(a, b):
        return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))

    def cos(a, b):
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    cos_min = float(min(cos(kern["p_reps"][0], plain["p_reps"][0]).min(),
                        cos(kern["q_reps"][0], plain["q_reps"][0]).min()))
    search_overlap = overlap(kern["docids"], plain_search["docids"])
    e2e_overlap = overlap(kern["docids"], plain["docids"])
    # how flat the ranking is: the spread of the top-k scores vs the score change
    # the encoders' bf16 differences cause on the same (query, passage) pairs
    spread = float(np.median(plain["scores"][:, 0] - plain["scores"][:, -1]))
    qk, pk = kern["q_reps"][0], kern["p_reps"][0]
    qp, pp = plain["q_reps"][0], plain["p_reps"][0]
    pairs = np.array([[int(d[1:]) for d in row] for row in plain["docids"]])
    shift = float(np.median(np.abs(np.einsum("qd,qkd->qk", qk, pk[pairs])
                                   - np.einsum("qd,qkd->qk", qp, pp[pairs]))))
    log(f"kernels vs plain: reps cosine min {cos_min:.6f} (>= 0.999); search over the same reps: "
        f"top-{args.k} overlap {search_overlap:.5f} (>= 0.99); median top-{args.k} score spread "
        f"{spread:.4g}, median score shift from the encoders {shift:.4g}")
    # Random-weight CLS reps rank a flat tail, which the encoders' bf16 roundings
    # reorder: the end-to-end bounds come from the readings (overlap 0.929, metric
    # gap 0.0078, i.e. 4 of 512 queries changing their hit), with a little room.
    metric_gap = max(abs(kern["metrics"][m] - plain["metrics"][m]) for m in plain["metrics"])
    log(f"end to end: top-{args.k} overlap {e2e_overlap:.5f} (>= 0.90), largest metric "
        f"difference {metric_gap:.4f} (<= 0.012)")
    check(cos_min >= 0.999, "reps disagree with the plain path")
    check(search_overlap >= 0.99, "search results disagree with the plain path")
    check(e2e_overlap >= 0.90, "end-to-end rankings disagree with the plain path")
    check(metric_gap <= 0.012, "metrics disagree with the plain path")
    keep = ("passages_per_s", "queries_per_s", "metrics")
    return {"launches": launches, "escalated_queries": escalated, "fallback_queries": fallbacks,
            "cos_min": cos_min, "search_overlap": search_overlap, "e2e_overlap": e2e_overlap,
            "metric_gap": metric_gap, "k5_max_abs_err": rank_err.max().item(),
            "score_spread": spread, "score_shift": shift,
            "kernels": {k: v for k, v in kern.items() if k in keep},
            "plain": {k: v for k, v in plain.items() if k in keep}}


def peak_mib(fn):
    """Peak device memory allocated while ``fn`` runs, above what was
    allocated before it, in MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def phase_contrastive(gen, con):
    """K3 and K4 vs their plain versions, fp32, H=768: at grad-cache scale,
    ragged, and at the training path's shape (Q=32, P=256)."""
    H, stride = 768, 8
    # fp32 sums in another order. Readings on the H100: loss rel err 0, grads
    # 4.4e-6 of max|grad|; the bounds keep 5-10x of room and still fail the
    # planted variants (target one column off: loss 7.9e-4, grads ~1).
    loss_tol, grad_tol = 1e-6, 2e-5
    results = {}
    for Q, P in ((4096, 32768), (1000, 8000), (32, 256)):
        q = 0.3 * torch.randn(Q, H, generator=gen, device="cuda")
        p = 0.3 * torch.randn(P, H, generator=gen, device="cuda")
        one = torch.ones((), device="cuda")
        rows = torch.arange(Q, device="cuda")

        def kernels():
            lse, tgt = con.contrastive_fwd(q, p, stride)
            return (lse, tgt, con.contrastive_bwd_dq(q, p, lse, stride, one),
                    con.contrastive_bwd_dp(q, p, lse, stride, one))

        def plain_versions():
            lse, tgt = con._reference_contrastive_fwd(q, p, stride)
            return (lse, tgt) + con._reference_contrastive_bwd(q, p, lse, stride, one)

        def plain_g(lse, target_shift=0, scale_nq=True):
            """g on the materialized [Q, P] (the plain K4's closed form), with
            an optional planted fault."""
            g = torch.exp(torch.matmul(q, p.T) - lse[:, None])
            g[rows, rows * stride + target_shift] -= 1.0
            return g / Q if scale_nq else g

        def planted(target_shift=0, scale_nq=True):
            s = torch.matmul(q, p.T)
            lse = torch.logsumexp(s, 1)
            g = plain_g(lse, target_shift, scale_nq)
            return lse, s[rows, rows * stride + target_shift], g @ p, g.T @ q

        def errors(got, want):
            loss_g = float((got[0] - got[1]).sum() / Q)
            loss_w = float((want[0] - want[1]).sum() / Q)
            return (abs(loss_g - loss_w) / abs(loss_w),
                    float((got[2] - want[2]).abs().max() / want[2].abs().max()),
                    float((got[3] - want[3]).abs().max() / want[3].abs().max()))

        out = kernels()
        torch.cuda.synchronize()
        want = plain_versions()
        loss_err, dq_err, dp_err = errors(out, want)
        abs_err = [float((a - b).abs().max()) for a, b in zip(out, want)]
        off = errors(planted(target_shift=1), want)
        no_nq = errors(planted(scale_nq=False), want)
        lse = want[0]
        del out, want
        t = {"fwd": cuda_ms(lambda: con.contrastive_fwd(q, p, stride)),
             "fwd_plain": cuda_ms(lambda: con._reference_contrastive_fwd(q, p, stride)),
             "dq": cuda_ms(lambda: con.contrastive_bwd_dq(q, p, lse, stride, one)),
             "dq_plain": cuda_ms(lambda: plain_g(lse) @ p),
             "dp": cuda_ms(lambda: con.contrastive_bwd_dp(q, p, lse, stride, one)),
             "dp_plain": cuda_ms(lambda: plain_g(lse).T @ q),
             "all": cuda_ms(kernels), "all_plain": cuda_ms(plain_versions)}
        kernel_mib, plain_mib = peak_mib(kernels), peak_mib(plain_versions)
        log(f"K3/K4 fp32 Q={Q} P={P} H={H} stride {stride}: loss rel err {loss_err:.3e} (<= "
            f"{loss_tol:g}), dq {dq_err:.3e} dp {dp_err:.3e} of max|grad| (<= {grad_tol:g}); "
            f"max_abs lse {abs_err[0]:.3e} tgt {abs_err[1]:.3e} dq {abs_err[2]:.3e} dp "
            f"{abs_err[3]:.3e}; planted: target+1 loss {off[0]:.3e} dq {off[1]:.3e} dp "
            f"{off[2]:.3e}, no 1/n_q dq {no_nq[1]:.3e} dp {no_nq[2]:.3e}")
        log(f"K3/K4 Q={Q} P={P} ms, kernel vs plain: forward {t['fwd']:.3f} vs "
            f"{t['fwd_plain']:.3f}; dq {t['dq']:.3f} vs {t['dq_plain']:.3f}; dp {t['dp']:.3f} vs "
            f"{t['dp_plain']:.3f}; forward+backward {t['all']:.3f} vs {t['all_plain']:.3f}; peak "
            f"memory forward+backward {kernel_mib:.1f} MiB vs {plain_mib:.1f} MiB")
        check(loss_err <= loss_tol and dq_err <= grad_tol and dp_err <= grad_tol,
              f"K3/K4 Q={Q} P={P}: kernels disagree with their plain versions")
        check(off[0] > loss_tol and min(off[1:]) > grad_tol,
              "a plain variant with the target one column off passes the bounds")
        check(min(no_nq[1:]) > grad_tol, "a plain variant without 1/n_q passes the bounds")
        check(kernel_mib < plain_mib, f"K3/K4 Q={Q} P={P}: kernel path's peak memory is not "
              f"below the plain path's")
        results[f"{Q}x{P}"] = {
            "loss_rel_err": loss_err, "dq_rel_err": dq_err, "dp_rel_err": dp_err,
            "max_abs_err": dict(zip(("lse", "tgt", "dq", "dp"), abs_err)), "ms": t,
            "peak_mib": kernel_mib, "plain_peak_mib": plain_mib, "target_off": off,
            "no_nq": no_nq}
        del q, p, lse
        torch.cuda.empty_cache()
    return results


def make_train_rows(rng, n_rows, n_passages, p_max_len, q_max_len):
    """Synthetic training rows (query, [positive, negatives...]): passages with
    lognormal lengths, the query a prefix of its positive passage."""
    rows = []
    for _ in range(n_rows):
        ps = []
        for _ in range(n_passages):
            L = int(np.clip(rng.lognormal(math.log(60), 0.5), 8, p_max_len))
            ps.append([101] + rng.integers(1000, 30522, L - 2).tolist() + [102])
        L = int(np.clip(rng.lognormal(math.log(10), 0.4), 4, q_max_len))
        rows.append((ps[0][:L - 1] + [102], ps))
    return rows


def phase_train(args, tmp):
    from denseretrievaltoolkits_torch.models.bert import BertConfig, save_config
    from denseretrievaltoolkits_torch.models.biencoder import DRModel, DRModelForInference
    from denseretrievaltoolkits_torch.ops import attn, contrastive as con
    from denseretrievaltoolkits_torch.run_encode import ModelArguments, pad_batch
    from denseretrievaltoolkits_torch.train.losses import contrastive_loss
    from denseretrievaltoolkits_torch.train.trainer import DataLoader, Trainer, TrainingArguments

    config = BertConfig(num_hidden_layers=TRAIN_LAYERS)
    arch = os.path.join(tmp, "bert-base-train")
    save_config(config, arch)
    margs = ModelArguments(model_name_or_path=arch, dtype="bfloat16", attention="fused",
                           fused_loss=True, pooling="first")
    B, n_p, q_len, p_len = TRAIN_BATCH, 8, 32, 128
    rng = np.random.default_rng(args.seed)
    rows = make_train_rows(rng, TRAIN_STEPS_PER_EPOCH * B, n_p, p_len, q_len)

    def collate(batch):
        return (pad_batch([q for q, _ in batch], q_len, 0),
                pad_batch([p for _, ps in batch for p in ps], p_len, 0))

    def loader():
        return DataLoader(rows, B, collate, shuffle=True, seed=args.seed)

    def build():
        return DRModel.build(margs, device="cuda", seed=args.seed)

    def trainer_for(label, model, epochs=2):
        targs = TrainingArguments(
            output_dir=os.path.join(tmp, label, "out"), cache_train_dir=os.path.join(
                tmp, label, "cache"), train_batch_size=B, max_epochs=epochs,
            learning_rate=TRAIN_LR, optimizer="adamw", scheduler="linear",
            warmup_ratio=0.1, log_every=1, save_per_train=epochs)
        return Trainer(targs, model, train_loader=loader())

    @contextlib.contextmanager
    def plain_versions():
        """The plain PyTorch versions in place of K1, K2 and the fused K3/K4 loss."""
        with mock.patch.object(attn, "fused_attention_ln", attn._reference_attention_ln), \
                mock.patch.object(attn, "fused_mlp_ln", attn._reference_mlp_ln), \
                mock.patch.object(con, "fused_contrastive_loss",
                                  lambda q, p, stride: contrastive_loss(q, p)[0]):
            yield

    def logged(trainer):
        with open(os.path.join(trainer.training_args.output_dir, "train_log.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        return ([r["loss"] for r in recs if "loss" in r],
                [r["mean_loss"] for r in recs if "mean_loss" in r])

    batches = list(loader())
    q_tok = int(batches[0][0]["attention_mask"].sum())
    p_tok = int(batches[0][1]["attention_mask"].sum())
    log(f"training path: bert-base L={config.num_hidden_layers} H={config.hidden_size} bf16 "
        f"fused attention + fused loss, tied; batch {B} queries x {n_p} passages (P={B * n_p}), "
        f"q_max_len {q_len} p_max_len {p_len}, {len(batches)} steps/epoch x 2 epochs, adamw "
        f"lr {TRAIN_LR:g} linear warmup 0.1; first batch {q_tok} + {p_tok} real tokens")

    def step1_grads():
        model = build()
        loss = model(*batches[0])["loss"]
        loss.backward()
        flat = torch.cat([prm.grad.flatten() for prm in model.parameters()
                          if prm.grad is not None])
        return float(loss.detach()), flat

    counted = (attn.fused_attention_ln, attn.fused_mlp_ln, con.contrastive_fwd,
               con.contrastive_bwd_dq, con.contrastive_bwd_dp)
    kern_trainer = trainer_for("kernels", build())
    for fn in counted:
        fn.launches = 0
    kern_trainer.train()
    launches = {fn.__name__: fn.launches for fn in counted}
    kern_losses, kern_means = logged(kern_trainer)
    log(f"launches on the training path: {json.dumps(launches)}")
    log(f"kernels: step losses {json.dumps([round(x, 5) for x in kern_losses])}, epoch means "
        f"{json.dumps(kern_means)}")
    check(all(n > 0 for n in launches.values()), "a kernel of the training path never launched")
    check(all(math.isfinite(x) for x in kern_losses), "a training loss is not finite")
    check(kern_means[-1] < kern_means[0], "the loss did not fall from the first epoch to the last")
    k_loss1, k_grad = step1_grads()

    with plain_versions():
        plain_trainer = trainer_for("plain", build())
        plain_trainer.train()
        plain_losses, plain_means = logged(plain_trainer)
        p_loss1, p_grad = step1_grads()
    step1_rel = abs(k_loss1 - p_loss1) / abs(p_loss1)
    k_norm, p_norm = k_grad.double().norm(), p_grad.double().norm()
    cos = float(torch.dot(k_grad.double(), p_grad.double()) / (k_norm * p_norm))
    norm_ratio = float(k_norm / p_norm)
    step_gap = max(abs(a - b) for a, b in zip(kern_losses, plain_losses))
    del k_grad, p_grad
    log(f"plain: step losses {json.dumps([round(x, 5) for x in plain_losses])}, epoch means "
        f"{json.dumps(plain_means)}")
    log(f"kernels vs plain: step-1 loss {k_loss1:.6f} vs {p_loss1:.6f} (rel {step1_rel:.3e}, "
        f"<= {TRAIN_STEP1_REL:g}); step-1 gradient cosine {cos:.6f} (>= {TRAIN_GRAD_COS:g}), "
        f"norm ratio {norm_ratio:.6f} (within {TRAIN_GRAD_NORM:g} of 1); largest step-loss gap "
        f"{step_gap:.4e} (<= {TRAIN_STEP_GAP:g})")
    check(abs(k_loss1 - kern_losses[0]) <= 1e-6 * abs(k_loss1) + 1e-6,
          "the step-1 loss does not repeat from the same init")
    check(step1_rel <= TRAIN_STEP1_REL, "step-1 loss disagrees with the plain path")
    check(cos >= TRAIN_GRAD_COS, "step-1 gradients disagree with the plain path")
    check(abs(norm_ratio - 1) <= TRAIN_GRAD_NORM,
          "step-1 gradient norms disagree with the plain path")
    check(step_gap <= TRAIN_STEP_GAP, "step losses disagree with the plain path")

    def steps_per_s(trainer, n=TRAIN_TIMED_STEPS):
        for b in batches[:2]:  # warm-up
            trainer.train_step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tokens = sum(int(batches[i % len(batches)][0]["attention_mask"].sum())
                     + int(batches[i % len(batches)][1]["attention_mask"].sum()) for i in range(n))
        return n / dt, tokens / dt

    # deploy format and checkpoint, before timing moves the trained weights
    result = os.path.join(kern_trainer.training_args.cache_train_dir, "result2")
    served = DRModelForInference.build(
        ModelArguments(model_name_or_path=result, dtype="bfloat16", attention="fused"),
        device="cuda")
    reps_gap = max(float((served.encode_query(batches[1][0])
                          - kern_trainer.model.encode_query(batches[1][0])).abs().max()),
                   float((served.encode_passage(batches[1][1])
                          - kern_trainer.model.encode_passage(batches[1][1])).abs().max()))
    del served
    resumed = trainer_for("resumed", build())
    resumed.load(os.path.join(kern_trainer.training_args.output_dir, "checkpoint", "ep2"))
    next_batch = batches[0]
    resumed_loss = float(resumed.train_step(next_batch))
    del resumed
    straight_loss = float(kern_trainer.train_step(next_batch))
    log(f"deploy format reloaded by DRModelForInference.build: reps max-abs gap {reps_gap:.3e} "
        f"(== 0); checkpoint ep2 resumed: next-step loss {resumed_loss:.6f} vs uninterrupted "
        f"{straight_loss:.6f}")
    check(reps_gap == 0.0, "the reloaded deploy format encodes differently")
    check(resumed_loss == straight_loss, "a resumed run does not repeat the uninterrupted run")

    # in turns, kernels / plain / plain / kernels
    rates = {"kernels": [steps_per_s(kern_trainer)]}
    with plain_versions():
        rates["plain"] = [steps_per_s(plain_trainer), steps_per_s(plain_trainer)]
    rates["kernels"].append(steps_per_s(kern_trainer))
    del kern_trainer, plain_trainer
    torch.cuda.empty_cache()
    kern_rate, plain_rate = (np.mean(rates[k], axis=0).tolist() for k in ("kernels", "plain"))
    log(f"train step ({TRAIN_TIMED_STEPS} steps after 2 warm-up, twice each, in turns): "
        f"kernels {kern_rate[0]:.3f} steps/s {kern_rate[1]:.0f} tokens/s; plain "
        f"{plain_rate[0]:.3f} steps/s {plain_rate[1]:.0f} tokens/s; readings "
        f"{json.dumps({k: [round(r[0], 4) for r in v] for k, v in rates.items()})}")
    return {"launches": launches, "losses": kern_losses, "epoch_means": kern_means,
            "plain_losses": plain_losses, "plain_epoch_means": plain_means,
            "step1_rel": step1_rel, "grad_cos": cos, "grad_norm_ratio": norm_ratio,
            "step_gap": step_gap,
            "reps_gap": reps_gap, "resumed_loss": resumed_loss, "straight_loss": straight_loss,
            "steps_per_s": kern_rate[0], "tokens_per_s": kern_rate[1],
            "plain_steps_per_s": plain_rate[0], "plain_tokens_per_s": plain_rate[1]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--passages", type=int, default=8192)
    parser.add_argument("--queries", type=int, default=512)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--k", type=int, default=100)
    parser.add_argument("--corpus_rows", type=int, default=1_000_000)
    parser.add_argument("--out", default="", help="also write the results as JSON here")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from denseretrievaltoolkits_torch.index.flat import blockwise_topk
    from denseretrievaltoolkits_torch.ops import _native, attn, contrastive, topk

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain versions score in true fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")
    t0 = time.perf_counter()
    _native.library()
    log(f"kernel build: {_native.build_seconds:.1f} s nvcc ({time.perf_counter() - t0:.1f} s "
        f"with load) -> {_native.BUILD_DIR}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    blocks = phase_block_kernels(gen, attn)
    k5 = phase_topk(gen, topk, blockwise_topk, args.corpus_rows)
    k34 = phase_contrastive(gen, contrastive)
    with tempfile.TemporaryDirectory() as tmp:
        main_path = phase_main_path(args, tmp)
        train = phase_train(args, tmp)

    src = "denseretrievaltoolkits_torch/csrc/"
    rows = [
        ("fused_attention_ln", src + "attn_ln.cu",
         "denseretrievaltoolkits_tpu/ops/attn.py:110", blocks["K1 bfloat16 B=64 S=156"]),
        ("fused_mlp_ln", src + "mlp_ln.cu", "denseretrievaltoolkits_tpu/ops/attn.py:252",
         blocks["K2 bfloat16 B=64 S=156"]),
        ("block_topj", src + "block_topj.cu", "denseretrievaltoolkits_tpu/ops/topk.py:37",
         k5["float32"]),
    ]
    kernels = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_path["launches"][name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"]} for name, source, replaces, r in rows]
    big = k34["4096x32768"]
    for name, line, err, ms in (
            ("contrastive_fwd", 39, max(big["max_abs_err"]["lse"], big["max_abs_err"]["tgt"]),
             "fwd"),
            ("contrastive_bwd_dq", 121, big["max_abs_err"]["dq"], "dq"),
            ("contrastive_bwd_dp", 150, big["max_abs_err"]["dp"], "dp")):
        kernels.append({"name": name, "route": "cuda", "source": src + "contrastive.cu",
                        "replaces": f"denseretrievaltoolkits_tpu/ops/contrastive.py:{line}",
                        "launches": train["launches"][name], "max_abs_err": err,
                        "ms": big["ms"][ms], "plain_ms": big["ms"][ms + "_plain"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "build_s": _native.build_seconds, "block_kernels": blocks,
                       "k5": k5, "k3_k4": k34, "main_path": main_path, "train": train}, fh,
                      indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

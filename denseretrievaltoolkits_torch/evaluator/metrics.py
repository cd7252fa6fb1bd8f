"""IR metrics: Recall@k, MRR@k, NDCG@k over binary hit matrices.

Exact semantic parity with the reference (``DRT/evaluator/metrics.py:4-59``),
including its particular conventions:

- input is a binary hit matrix [nq, depth] (1 = retrieved doc contains answer);
- Recall@k and MRR@k credit only the FIRST hit per query (:4-25);
- NDCG@k uses binary gains 1/log(rank+2) with an idcg that accumulates
  min(total_hits, k) ideal terms per query, where total_hits counts hits at any
  depth, and at least one ideal term even for zero-hit queries (:28-47);
- ``get_metrics`` returns SUMS over queries; the caller accumulates over batches
  and divides by the total query count (``trainer.py:319-321,338-339``).

Intended-semantics fix (SURVEY.md §2.2): the reference pools dcg/idcg across
the whole batch and returns their ratio (:45-46), which its trainer then sums
over batches and divides by query count — a quantity that depends on batch
size.  Here ``ndcg`` returns the SUM of per-query dcg_q/idcg_q, so the
trainer's accumulate-then-divide produces the standard mean NDCG.

Vectorized numpy (the reference loops in Python per query, :4-47).

The port's own copy of ``denseretrievaltoolkits_tpu/evaluator/metrics.py``,
with the same names and behaviour.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _as_matrix(indices) -> np.ndarray:
    return np.asarray(indices, dtype=np.int64)


def recall(indices, topk: Sequence[int]) -> List[float]:
    hits = _as_matrix(indices) != 0
    any_hit = hits.any(axis=1)
    first = np.where(any_hit, hits.argmax(axis=1), np.iinfo(np.int64).max)
    return [float(np.sum(first < k)) for k in topk]


def mrr(indices, topk: Sequence[int]) -> List[float]:
    hits = _as_matrix(indices) != 0
    any_hit = hits.any(axis=1)
    first = np.where(any_hit, hits.argmax(axis=1), np.iinfo(np.int64).max)
    rr = np.where(any_hit, 1.0 / (first + 1.0), 0.0)
    return [float(np.sum(np.where(first < k, rr, 0.0))) for k in topk]


def ndcg(indices, topk: Sequence[int]) -> List[float]:
    hits = _as_matrix(indices) != 0
    nq, depth = hits.shape
    ranks = np.arange(depth)
    gains = 1.0 / np.log(ranks + 2.0)  # natural log, as in the reference (:40)

    result = []
    # total hits per query at ANY depth (reference `cnt`, :34-37)
    cnt = hits.sum(axis=1)
    ideal_terms = np.maximum(cnt, 1)  # at least one ideal term (:41)
    cum = np.concatenate([[0.0], np.cumsum(gains)])
    for k in topk:
        dcg_q = np.sum(np.where(hits[:, :k], gains[:k], 0.0), axis=1)
        n_ideal = np.minimum(ideal_terms, k)
        idcg_q = cum[n_ideal]  # per-query sum_{i < n_ideal} 1/log(i+2)
        result.append(float(np.sum(dcg_q / idcg_q)))
    return result


def get_metrics(indices, topk: Sequence[int]) -> Dict[str, float]:
    """Metric-name → value dict; all values are per-query sums over the batch."""
    result: Dict[str, float] = {}
    for name, vals in zip(
        ["Recall@", "MRR@", "NDCG@"], [recall(indices, topk), mrr(indices, topk), ndcg(indices, topk)]
    ):
        for k, v in zip(topk, vals):
            result[name + str(k)] = v
    return result

"""TREC run-file interop + multi-shard retrieval result merging.

Mirrors ``DRT/model/utils.py:126-169`` (save/load TREC runs) and
``utils.py:215-229`` (merge per-shard qid→doc→score maps, keep global top-k).

The port's own copy of ``denseretrievaltoolkits_tpu/evaluator/trec.py``, with the
same names and behaviour.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union


def save_as_trec(
    rank_result: Dict[str, Dict[str, float]], output_path: str, run_id: str = "drt_tpu"
) -> None:
    """<query_id> Q0 <doc_id> <rank> <score> <run_id>, sorted by score."""
    with open(output_path, "w") as fh:
        for qid in rank_result:
            ranked = sorted(rank_result[qid].items(), key=lambda kv: kv[1], reverse=True)
            for i, (doc_id, score) in enumerate(ranked):
                fh.write(f"{qid} Q0 {doc_id} {i + 1} {score} {run_id}\n")


def load_from_trec(
    input_path: str, as_list: bool = False, max_len_per_q: int = None
) -> Dict[str, Union[Dict[str, float], List[Tuple[str, float]]]]:
    """Read 6-column TREC or 3-column (qid docid score) runs."""
    rank_result: Dict = {}
    cnt = 0
    with open(input_path) as fh:
        for line in fh:
            content = line.strip().split()
            if len(content) == 6:
                qid, _, doc_id, _, score, _ = content
            elif len(content) == 3:
                qid, doc_id, score = content
            else:
                raise ValueError("Invalid run format")
            if qid not in rank_result:
                rank_result[qid] = [] if as_list else {}
                cnt = 0
            if max_len_per_q is None or cnt < max_len_per_q:
                if as_list:
                    rank_result[qid].append((doc_id, float(score)))
                else:
                    rank_result[qid][doc_id] = float(score)
            cnt += 1
    return rank_result


def merge_retrieval_results_by_score(
    results: List[Dict[str, Dict[str, float]]], topk: int = 100
) -> Dict[str, Dict[str, float]]:
    """Union per-qid doc→score maps from N index shards; keep global top-k."""
    merged: Dict[str, Dict[str, float]] = {}
    for result in results:
        for qid, docs in result.items():
            bucket = merged.setdefault(qid, {})
            for doc_id, score in docs.items():
                if doc_id not in bucket:
                    bucket[doc_id] = score
    for qid in merged:
        merged[qid] = dict(
            sorted(merged[qid].items(), key=lambda kv: kv[1], reverse=True)[:topk]
        )
    return merged

"""Format converters between the pipeline's dump artifacts.

The trainer writes per-epoch retrieval dumps as jsonl rows
({doc_id, query_id, query, document, answers, score} — train/trainer.py,
mirroring reference trainer.py:323-337), while the standalone top-k accuracy
CLI consumes a DPR-style JSON object {qid: {answers, contexts:[{text, score}]}}
(evaluator/nq_eval.py:221-249, reference format).  This bridges them, plus a
TREC export of the same dumps.

The port's own copy of ``denseretrievaltoolkits_tpu/evaluator/convert.py``, with
the same names and behaviour.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict

from .trec import save_as_trec


def retrieval_jsonl_to_nq_json(jsonl_path: str, out_path: str = None) -> Dict:
    """Trainer retrieval dump (jsonl rows) → nq_eval retrieval JSON."""
    per_query: Dict = {}
    with open(jsonl_path, encoding="utf-8") as fh:
        for line in fh:
            row = json.loads(line)
            qid = row["query_id"]
            entry = per_query.setdefault(qid, {"answers": row["answers"], "contexts": []})
            entry["contexts"].append(
                {
                    # nq_eval reads text as "title\ntext" (nq_eval.py:240);
                    # the dump stores the already-joined passage text
                    "text": "\n" + row.get("document", ""),
                    "docid": row["doc_id"],
                    "score": row.get("score"),
                }
            )
    # contexts must be rank-ordered; dumps are written in rank order per query
    # but sort defensively by score when present
    for entry in per_query.values():
        if all(c.get("score") is not None for c in entry["contexts"]):
            entry["contexts"].sort(key=lambda c: -c["score"])
    if out_path:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(per_query, fh, ensure_ascii=False)
    return per_query


def retrieval_jsonl_to_trec(jsonl_path: str, out_path: str,
                            run_id: str = "drt_tpu") -> None:
    """Trainer retrieval dump → TREC run file."""
    run: Dict[str, Dict[str, float]] = defaultdict(dict)
    with open(jsonl_path, encoding="utf-8") as fh:
        for line in fh:
            row = json.loads(line)
            score = row.get("score")
            if score is None:
                # rank-order fallback: later rows rank lower
                score = -len(run[row["query_id"]])
            run[row["query_id"]][row["doc_id"]] = float(score)
    save_as_trec(dict(run), out_path, run_id)

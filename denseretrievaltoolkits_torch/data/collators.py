"""Collators: variable-length token lists → fixed-shape numpy batches.

Role-for-role equivalents of the reference's seven collators
(``DRT/dataset/data_collator.py:6-268``), with the same external tuple
contracts, but emitting numpy int32 arrays padded to the static q_max/p_max
shapes (the reference already pads to ``max_length``).

The port's own copy of ``denseretrievaltoolkits_tpu/data/collators.py``, with
the same names and behaviour.

``tokenizer.prepare_for_model`` adds the model's special tokens and truncates
(reference data_collator.py:6-15); the final pad is done here in numpy rather
than via ``tokenizer.pad``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def create_one_example(text_encoding: List[int], tokenizer, q_max_len=None, p_max_len=None):
    """Add special tokens + truncate one pre-tokenized text
    (reference data_collator.py:6-15)."""
    return tokenizer.prepare_for_model(
        text_encoding,
        truncation="only_first",
        max_length=q_max_len if q_max_len else p_max_len,
        padding=False,
        return_attention_mask=False,
        return_token_type_ids=False,
    )["input_ids"]


def create_pair_example(query_encoding, text_encoding, tokenizer, max_len):
    """Joined (query, passage) pair with special tokens
    (reference data_collator.py:71-81,230-240)."""
    return tokenizer.prepare_for_model(
        query_encoding,
        text_encoding,
        truncation="only_first",
        max_length=max_len,
        padding=False,
        return_attention_mask=False,
        return_token_type_ids=False,
    )["input_ids"]


def bucket_length(longest: int, max_len: int, step: int = 32) -> int:
    """Smallest multiple of ``step`` >= ``longest``, capped at ``max_len``.

    Per-batch padding in a few fixed lengths (the reference pads each batch
    to its own max via ``tokenizer.pad``): lengths are quantized to at most
    ``ceil(max_len/step)`` buckets, so batches come in a handful of shapes."""
    return min(max_len, max(step, -(-longest // step) * step))


def pad_batch(sequences: Sequence[List[int]], max_len: int, pad_id: int,
              bucket_step: int = 0) -> Dict[str, np.ndarray]:
    """Pad token-id lists to [N, max_len]; returns input_ids + attention_mask.

    ``bucket_step`` > 0 pads to the batch's length bucket instead of the
    global ``max_len`` (see ``bucket_length``) — pair with a length-sorted
    loader so batches are length-homogeneous and the saved padding is real
    compute, not just moved to the longest row."""
    if bucket_step:
        max_len = bucket_length(max((len(s) for s in sequences), default=1),
                                max_len, bucket_step)
    n = len(sequences)
    input_ids = np.full((n, max_len), pad_id, dtype=np.int32)
    attention_mask = np.zeros((n, max_len), dtype=np.int32)
    for i, seq in enumerate(sequences):
        L = min(len(seq), max_len)
        input_ids[i, :L] = seq[:L]
        attention_mask[i, :L] = 1
    return {"input_ids": input_ids, "attention_mask": attention_mask}


def _pad_id(tokenizer) -> int:
    pid = getattr(tokenizer, "pad_token_id", None)
    return 0 if pid is None else pid


class EVCollator:
    """Eval queries → (qids, query batch, answers, raw query texts)
    (reference data_collator.py:18-55)."""

    def __init__(self, data_args, tokenizer, sampler=None):
        self.tokenizer = tokenizer
        self.max_q_len = data_args.q_max_len

    def __call__(self, features):
        qid = [s["query_id"] for s in features]
        # ExactMatch rows carry answer strings; Relevancy rows carry positive
        # docids (EvalPreProcessor) — either serves as the relevance labels.
        ans = [s.get("answers", s.get("positives_ids")) for s in features]
        qt = [s.get("original", "") for s in features]
        enq = [create_one_example(s["query"], self.tokenizer, q_max_len=self.max_q_len)
               for s in features]
        q = pad_batch(enq, self.max_q_len, _pad_id(self.tokenizer))
        return qid, q, ans, qt


class EVRRCollator:
    """Eval (query, doc) joined pairs → (qids, pair batch, answers, docs, docids)
    (reference data_collator.py:58-110).

    ``bucket_step`` > 0 enables bucketed variable-length padding (pair with a
    length-sorted loader; the reranker eval groups scores by qid, so
    iteration order is free)."""

    def __init__(self, data_args, tokenizer, bucket_step: int = 0):
        self.tokenizer = tokenizer
        self.max_len = data_args.q_max_len + data_args.p_max_len
        self.bucket_step = bucket_step

    def __call__(self, features):
        qid = [s["query_id"] for s in features]
        did = [s["doc_id"] for s in features]
        ans = [s["answers"] for s in features]
        doc = [s["original"] for s in features]
        pairs = [
            create_pair_example(s["query"], s["document"], self.tokenizer, self.max_len)
            for s in features
        ]
        batch = pad_batch(pairs, self.max_len, _pad_id(self.tokenizer),
                          bucket_step=self.bucket_step)
        return qid, batch, ans, doc, did


class QPCollator:
    """Train batches: runs the negative sampler inside collate, flattens each
    query's (1 positive + n-1 negative) docs (reference data_collator.py:113-157)."""

    def __init__(self, data_args, sampler, tokenizer):
        self.sampler = sampler
        self.tokenizer = tokenizer
        self.max_q_len = data_args.q_max_len
        self.max_p_len = data_args.p_max_len

    def __call__(self, features):
        queries, documents = self.sampler(features)
        enq = [create_one_example(q, self.tokenizer, q_max_len=self.max_q_len) for q in queries]
        end = [
            create_one_example(d, self.tokenizer, p_max_len=self.max_p_len)
            for docs in documents
            for d in docs
        ]
        pad = _pad_id(self.tokenizer)
        return pad_batch(enq, self.max_q_len, pad), pad_batch(end, self.max_p_len, pad)


class PPCollator:
    """Corpus passages → (docids, passage batch) (reference data_collator.py:160-193).

    ``bucket_step`` > 0 enables bucketed variable-length padding (see
    ``bucket_length``) — the corpus-encode throughput path for real corpora
    whose lengths sit well under ``p_max_len``."""

    def __init__(self, data_args, tokenizer, bucket_step: int = 0):
        self.tokenizer = tokenizer
        self.max_p_len = data_args.p_max_len
        self.bucket_step = bucket_step

    def __call__(self, features):
        did = [s["id"] for s in features]
        enp = [create_one_example(s["text"], self.tokenizer, p_max_len=self.max_p_len)
               for s in features]
        return did, pad_batch(enp, self.max_p_len, _pad_id(self.tokenizer),
                              bucket_step=self.bucket_step)


class EncodeCollator:
    """Generic (ids, batch) for offline encoding (reference data_collator.py:196-210).

    ``bucket_step`` > 0 enables bucketed variable-length padding (pair with a
    length-sorted loader; see ``bucket_length``)."""

    def __init__(self, tokenizer, padding="max_length", q_max_len=None, p_max_len=None,
                 bucket_step: int = 0):
        self.tokenizer = tokenizer
        self.q_max_len = q_max_len
        self.p_max_len = p_max_len
        self.bucket_step = bucket_step

    def __call__(self, features):
        text_ids = [x["query_id"] if "query_id" in x else x["doc_id"] for x in features]
        texts = [x["query"] if "query" in x else x["text"] for x in features]
        max_len = self.q_max_len if self.q_max_len else self.p_max_len
        encoded = [
            create_one_example(t, self.tokenizer, q_max_len=self.q_max_len,
                               p_max_len=self.p_max_len)
            for t in texts
        ]
        return text_ids, pad_batch(encoded, max_len, _pad_id(self.tokenizer),
                                   bucket_step=self.bucket_step)


class DRInferenceCollator:
    """Pass-through ids collator (reference data_collator.py:213-218)."""

    def __call__(self, features):
        text_ids = [x["doc_id"] for x in features]
        return text_ids, features


class RRCollator:
    """Reranker train pairs: (q, docs[0]) positives + (q, docs[1:]) negatives,
    joined and padded to q_max+p_max (reference data_collator.py:221-268)."""

    def __init__(self, data_args, sampler, tokenizer):
        self.sampler = sampler
        self.tokenizer = tokenizer
        self.max_len = data_args.q_max_len + data_args.p_max_len

    def __call__(self, features):
        queries, documents = self.sampler(features)
        pos_pair, neg_pair = [], []
        for q, ds in zip(queries, documents):
            pos_pair.append(create_pair_example(q, ds[0], self.tokenizer, self.max_len))
            for d in ds[1:]:
                neg_pair.append(create_pair_example(q, d, self.tokenizer, self.max_len))
        pad = _pad_id(self.tokenizer)
        return (
            pad_batch(pos_pair, self.max_len, pad),
            pad_batch(neg_pair, self.max_len, pad),
        )

"""Negative samplers, run host-side inside the train collator.

The port's own copy of ``denseretrievaltoolkits_tpu/data/samplers.py``:

- ``RandomSampleNegatives``: 1 random positive + (n-1) shuffled negatives per
  query (reference ``DRT/trainer/sampler.py:23-46``), with a seeded RNG for
  reproducibility (the reference used the global ``random`` state). The same
  draws as the JAX package's for the same seed.
- ``BM25Negatives``: mines top-k BM25 negatives for every train query over the
  pool of all train passages, excluding the query's own positive span, and
  caches the mined dataset as jsonl under the reference's key and layout
  (``{cache}/BM25data/bm25negatives.<key>``). It mines with the native engine
  (``evaluator/bm25_native.py``, built at first use; a failed build raises)
  unless ``use_native=False`` asks for the Python ``BM25Retriever``, where the
  reference quietly falls back to Python.

Dense hard-negative mining from the trainer's index lives in ``mine/``.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Tuple

from ..evaluator.bm25 import BM25Retriever

Batch = Tuple[List[List[int]], List[List[List[int]]]]


class RandomSampleNegatives:
    def __init__(self, data_args, seed: int = 0):
        self.num_negative = data_args.train_n_passages - 1
        self.positive_no_shuffle = getattr(data_args, "positive_passage_no_shuffle", False)
        self.negative_no_shuffle = getattr(data_args, "negative_passage_no_shuffle", False)
        self._rng = random.Random(seed)

    def __call__(self, samples) -> Batch:
        queries, documents = [], []
        for sample in samples:
            queries.append(sample["query"])
            docs = []
            positives = sample["positives"]
            if self.positive_no_shuffle:
                docs.append(positives[0])
            else:
                docs.append(self._rng.choice(positives))
            negatives = sample["negatives"]
            if len(negatives) < self.num_negative:
                raise ValueError(
                    f"need {self.num_negative} negatives, sample has {len(negatives)}"
                )
            if self.negative_no_shuffle:
                chosen = list(range(self.num_negative))
            else:
                chosen = self._rng.sample(range(len(negatives)), self.num_negative)
            docs.extend(negatives[i] for i in chosen)
            documents.append(docs)
        return queries, documents


class BM25Negatives:
    """Offline BM25 hard-negative miner + collate-time sampler."""

    def __init__(self, data_args, vocab_size: int, seed: int = 0,
                 use_native: bool = True):
        self.cache_dir = data_args.data_cache_dir
        self.num_negative = data_args.train_n_passages - 1
        if use_native:
            # built at first use; a failed build raises (no quiet fallback to Python)
            from ..evaluator.bm25_native import NativeBM25Retriever

            self.retriever = NativeBM25Retriever(self.num_negative, vocab_size, seed=seed)
        else:
            self.retriever = BM25Retriever(self.num_negative, vocab_size, seed=seed)
        self._random = RandomSampleNegatives(data_args, seed=seed)

    @staticmethod
    def _cache_key(corpus, num_negative: int, retriever) -> str:
        """Content key for the mined-negatives cache.

        The reference cached under one fixed name (``sampler.py:61-65``), so a
        changed dataset or ``train_n_passages`` silently reloaded stale
        negatives.  Hash the FULL dataset content (every row's query,
        positives and negatives — a strided sample let edits between sample
        strides silently reuse stale mines; advisor r3) plus every parameter
        that changes the mining output.  sha1 streams ~0.5 GB/s, a rounding
        error next to the mining itself."""
        import hashlib

        h = hashlib.sha1()
        h.update(f"n={len(corpus)};neg={num_negative};".encode())
        for attr in ("k1", "b", "eps"):
            h.update(f"{attr}={getattr(retriever, attr, None)};".encode())
        for s in corpus:
            h.update(repr(s.get("query")).encode())
            for field in ("positives", "negatives"):
                for p in s.get(field) or []:
                    h.update(repr(p).encode())
                h.update(b";")
        return h.hexdigest()[:12]

    def load_passages(self, corpus) -> List[dict]:
        """Mine (or load cached) BM25 negatives for every train sample.

        Returns the train samples with their ``negatives`` replaced by mined
        BM25 negatives (reference sampler.py:57-99, cache layout
        ``{cache}/BM25data/bm25negatives.<key>`` — keyed by dataset content +
        mining params so a changed dataset re-mines instead of silently
        loading stale negatives).
        """
        corpus = list(corpus)
        out_dir = os.path.join(self.cache_dir or ".", "BM25data")
        key = self._cache_key(corpus, self.num_negative, self.retriever)
        cache_name = f"bm25negatives.{key}"
        cache_file = os.path.join(out_dir, cache_name)
        if os.path.exists(cache_file):
            with open(cache_file, encoding="utf-8") as fh:
                return [json.loads(line) for line in fh]

        bp, ep = self.retriever.load_passages(corpus)
        data = []
        if hasattr(self.retriever, "search_batch"):
            # native engine: one C++ call mines every query with the
            # own-positive span excluded in-engine
            k = self.num_negative + max(len(s["positives"]) for s in corpus)
            batch_ids = self.retriever.search_batch(
                [s["query"] for s in corpus], k, excl_begin=bp, excl_end=ep
            )
            import random as _random

            pad_rng = _random.Random(0)
            n_docs = len(self.retriever.passage)
            for sample, ids, b, e in zip(corpus, batch_ids, bp, ep):
                chosen = [int(d) for d in ids if d >= 0][: self.num_negative]
                # sparse-vocab queries can match fewer than k docs: pad with
                # random docs outside the own-positive span (reference
                # index.py:133-137 semantics)
                taken = set(chosen)
                while len(chosen) < self.num_negative and n_docs > e - b + len(taken):
                    cand = pad_rng.randrange(n_docs)
                    if cand in taken or b <= cand < e:
                        continue
                    chosen.append(cand)
                    taken.add(cand)
                row = dict(sample)
                row["negatives"] = [self.retriever.passage[d] for d in chosen]
                data.append(row)
        else:
            for sample, b, e in zip(corpus, bp, ep):
                mined = []
                # over-fetch so own-positive hits can be skipped
                neg_docs = self.retriever.search(
                    sample["query"], self.num_negative + len(sample["positives"])
                )
                for doc in neg_docs:
                    if b <= doc < e:  # the query's own positive span — exclude
                        continue
                    mined.append(self.retriever.passage[doc])
                    if len(mined) == self.num_negative:
                        break
                row = dict(sample)
                row["negatives"] = mined
                data.append(row)

        self.save(data, out_dir, cache_name)
        return data

    def save(self, data, out_dir: str, data_name: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, data_name), "w", encoding="utf-8") as fh:
            for sample in data:
                json.dump(sample, fh, ensure_ascii=False)
                fh.write("\n")

    def __call__(self, samples) -> Batch:
        """Collate-time sampling over the mined negatives (intended semantics
        of reference sampler.py:111-127, whose live-search path kept positives
        due to the inverted filter)."""
        return self._random(samples)

"""Negative samplers, run host-side inside the train collator.

The port's own copy of ``denseretrievaltoolkits_tpu/data/samplers.py``:

- ``RandomSampleNegatives``: 1 random positive + (n-1) shuffled negatives per
  query (reference ``DRT/trainer/sampler.py:23-46``), with a seeded RNG for
  reproducibility (the reference used the global ``random`` state). The same
  draws as the JAX package's for the same seed.
- ``BM25Negatives``: the offline BM25 miner, not ported yet: it comes with
  its retriever (``evaluator/bm25.py``) and the native path over
  ``native/bm25.cpp`` (ROADMAP queue 1, item 'Mining and BM25').
"""

from __future__ import annotations

import random
from typing import List, Tuple

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
    """Offline BM25 hard-negative miner: not ported yet."""

    def __init__(self, data_args, vocab_size: int, seed: int = 0, use_native: bool = True):
        raise NotImplementedError(
            "BM25 hard-negative mining is not ported yet (ROADMAP queue 1, item 'Mining and "
            "BM25'; its native path needs native/bm25.cpp)")

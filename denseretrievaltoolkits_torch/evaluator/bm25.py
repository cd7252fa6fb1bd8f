"""BM25 retrieval over token-id lists (host-side).

The port's own copy of ``denseretrievaltoolkits_tpu/evaluator/bm25.py``, with
the same names and behaviour (``tests/test_torch_shared.py`` holds it to the
original). Correct-semantics rebuild of the reference ``BM25Retriever``
(``DRT/evaluator/index.py:57-166``), which is used for hard-negative mining.
Fixed defects (SURVEY.md §2.2):

- per-doc term-frequency dicts are independent (the reference's
  ``[{}] * corpus_size`` aliases one dict, index.py:87);
- ``search`` no longer shadows its ``k`` parameter (index.py:130-134) and pads
  deterministically from a seeded RNG, excluding already-chosen docs;
- scoring uses the standard BM25 denominator ``tf + k1*(1-b+b*len/avg)``
  (as the reference's own ``retrieve`` does, index.py:158-159 — its ``search``
  dropped the k1 factor).

Parameters match the reference: k1=1.2, b=0.75, eps=0.25·avg_idf floor for
negative idfs (index.py:58-62,100-115).
"""

from __future__ import annotations

import math
import random
from collections import Counter
from typing import Dict, List, Sequence, Set, Tuple


class BM25Retriever:
    def __init__(self, topK: int = 10, vocab_size: int = None, seed: int = 0):
        self.topK = topK
        self.eps = 0.25
        self.k1 = 1.2
        self.b = 0.75
        self.idf: Dict[int, float] = {}
        self.doc_contained_word: Dict[int, Set[int]] = {}
        self.vocab_size = vocab_size
        self.passage: List[List[int]] = []
        self.cnt: List[Counter] = []
        self.avg_doc_len = 0.0
        self._rng = random.Random(seed)

    def load_passages(self, corpus: Sequence[dict]) -> Tuple[List[int], List[int]]:
        """Flatten each sample's positives+negatives into the passage pool.

        Returns per-sample spans [bp, ep) covering that sample's OWN positive
        passages (used by the miner to exclude them from its negatives),
        mirroring reference index.py:69-83.
        """
        bp, ep = [], []
        for sample in corpus:
            bp.append(len(self.passage))
            for p in sample["positives"]:
                self.passage.append(list(p))
            ep.append(len(self.passage))
            for n in sample.get("negatives", []):
                self.passage.append(list(n))

        corpus_size = len(self.passage)
        self.cnt = [Counter(doc) for doc in self.passage]
        for i, counter in enumerate(self.cnt):
            for word in counter:
                self.doc_contained_word.setdefault(word, set()).add(i)

        idf_sum = 0.0
        negative_idf_words = []
        for word, doc_ids in self.doc_contained_word.items():
            df = len(doc_ids)
            idf = math.log(corpus_size - df + 0.5) - math.log(df + 0.5)
            self.idf[word] = idf
            idf_sum += idf
            if idf < 0:
                negative_idf_words.append(word)
        if self.idf:
            average_idf = idf_sum / len(self.idf)
            floor = self.eps * average_idf
            for word in negative_idf_words:
                self.idf[word] = floor

        self.avg_doc_len = sum(len(d) for d in self.passage) / max(corpus_size, 1)
        return bp, ep

    def _score_term(self, word: int, doc_id: int) -> float:
        tf = self.cnt[doc_id][word]
        dl = len(self.passage[doc_id])
        denom = tf + self.k1 * (1 - self.b + self.b * dl / self.avg_doc_len)
        return self.idf[word] * tf * (self.k1 + 1) / denom

    def search(self, query_tokens: Sequence[int], k: int = 1000) -> List[int]:
        """Top-k passage indices by BM25 score for a token-id query."""
        score: Dict[int, float] = {}
        for word in query_tokens:
            for doc_id in self.doc_contained_word.get(word, ()):
                score[doc_id] = score.get(doc_id, 0.0) + self._score_term(word, doc_id)
        ranked = sorted(score.items(), key=lambda kv: -kv[1])
        out = [doc_id for doc_id, _ in ranked[:k]]
        # pad with deterministic random unseen docs up to k (reference pads with
        # random ids, index.py:133-137)
        if len(out) < k and len(self.passage) > len(out):
            chosen = set(out)
            pool = [i for i in range(len(self.passage)) if i not in chosen]
            self._rng.shuffle(pool)
            out.extend(pool[: k - len(out)])
        return out

    def retrieve(self, query: Sequence[int], documents: Sequence[Sequence[int]]) -> List[int]:
        """Rank a provided doc subset by BM25; returns topK indices into it
        (reference index.py:142-166)."""
        scores = []
        for doc in documents:
            freqs = Counter(doc)
            dl = len(doc)
            s = 0.0
            for word in query:
                if word in freqs:
                    denom = freqs[word] + self.k1 * (1 - self.b + self.b * dl / self.avg_doc_len)
                    s += self.idf.get(word, 0.0) * freqs[word] * (self.k1 + 1) / denom
            scores.append(s)
        order = sorted(range(len(documents)), key=lambda i: -scores[i])
        return order[: self.topK]

"""Dense hard-negative mining from the trainer's device-resident index.

Counterpart of ``denseretrievaltoolkits_tpu/mine/miner.py`` (:39-138): the
ANCE-style refresh. Between epochs the corpus index is on the card, so the
current model's hardest negatives are one top-k sweep over the train queries:

  encode the train queries (``model.encode_query``, batches of 128 at
  ``q_max_len``) -> ``trainer.index.batch_search(k = n_negatives + headroom)``
  in mode ``serve`` unless another is given (K8 over a flat index) -> drop the
  sample's own positives (by docid, else by token list) -> the next
  ``n_negatives`` passages' token lists become the sample's ``negatives``.

The reps stay on the card from the encode to the search. On a mesh every rank
encodes the same train queries on its own card (the JAX package's ``_local_rows``,
miner.py:66-70 there, takes a host's copy of the replicated batch), the sharded
index's search is collective and gives every rank the same rows, so every rank mines
the same negatives. A ``-1`` row (fewer
candidates than k) is skipped, and a sample is refreshed only when it gets all
``n_negatives``. The mined rows feed the same sampler and collator as before.
The reference measured the envelope (its docstring): at 7 mined negatives from
depth ~17, 2 of 5 seeds collapsed; at 1 mined negative refresh won on every
seed.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import torch

from ..data.collators import create_one_example, pad_batch
from ..data.loaders import pad_to_batch

logger = logging.getLogger(__name__)


class DenseMiner:
    """Mines negatives for tokenized train samples from ``trainer.index``."""

    def __init__(self, trainer, tokenizer, data_args, headroom: int = 10,
                 search_mode: Optional[str] = None):
        self.trainer = trainer
        self.tokenizer = tokenizer
        self.q_max_len = data_args.q_max_len
        self.n_negatives = data_args.train_n_passages - 1
        self.headroom = headroom
        # a bulk sweep over every train query: the serve selection by default, whatever
        # the evaluation's search_mode (a negative at rank k +- 1 trains the same)
        self.search_mode = "serve" if search_mode is None else search_mode

    def _encode_queries(self, samples: Sequence[dict], batch_size: int = 128) -> torch.Tensor:
        """The samples' query reps [n, D], on the model's device."""
        pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        reps = []
        for start in range(0, len(samples), batch_size):
            enq = [create_one_example(s["query"], self.tokenizer, q_max_len=self.q_max_len)
                   for s in samples[start:start + batch_size]]
            padded, valid = pad_to_batch(pad_batch(enq, self.q_max_len, pad_id), batch_size)
            reps.append(self.trainer.model.encode_query(padded)[:valid])
        return torch.cat(reps)

    def mine(self, train_samples: Sequence[dict],
             positive_docids: Optional[Sequence[set]] = None) -> List[dict]:
        """The train samples with ``negatives`` replaced by dense-mined ones.
        ``positive_docids``: per-sample docid sets to exclude; without them a sample's
        own positives are excluded by their token lists."""
        trainer = self.trainer
        if trainer.index is None:
            raise RuntimeError("corpus index not built; run trainer.evaluate (or "
                               "_encoding_corpus) before mining")
        corpus_ds = getattr(trainer.corpus_dataloader, "dataset", None)
        if corpus_ds is None:
            raise RuntimeError("miner needs the corpus dataloader's dataset for "
                               "token-id lookup")
        samples = list(train_samples)
        q_reps = self._encode_queries(samples)
        k = min(self.n_negatives + self.headroom, len(trainer.index))
        _, indices = trainer.index.batch_search(q_reps, k, batch_size=256, quiet=True,
                                                mode=self.search_mode)
        perm = trainer._row2ds  # length-sorted encodes: index row -> dataset row
        mined: List[dict] = []
        refreshed = 0
        for i, sample in enumerate(samples):
            by_id = positive_docids is not None
            own = positive_docids[i] if by_id else {tuple(p) for p in sample["positives"]}
            negs = []
            for row in indices[i]:
                if row < 0:  # trainer.idx[-1] would mine the corpus's last doc
                    continue
                ds_row = int(perm[int(row)]) if perm is not None else int(row)
                doc_tokens = corpus_ds[ds_row]["text"]
                if (trainer.idx[int(row)] if by_id else tuple(doc_tokens)) in own:
                    continue
                negs.append(list(doc_tokens))
                if len(negs) == self.n_negatives:
                    break
            row_out = dict(sample)
            if len(negs) == self.n_negatives:
                row_out["negatives"] = negs
                refreshed += 1
            mined.append(row_out)
        logger.info("dense miner refreshed %d/%d samples (k=%d)", refreshed, len(samples), k)
        return mined

"""Host data loading: deterministic, shardable, static-shape batch iterators.

Replaces the reference's four ``torch.utils.data.DataLoader`` factory classes
(``DRT/dataloader/*.py``).  A loader is a plain Python iterator that applies a
collator to index-selected examples, so its order under a seed is the JAX
package's exactly. The loader yields global batches (no per-rank
``DistributedSampler``; the ``shard_num``/``shard_idx`` options exist for
multi-process runs, where each process feeds its slice of the global batch).

Static shapes: training iterates full batches only (``drop_last``); eval/corpus
loaders pad the final batch up to ``batch_size`` and report the valid count.

The port's own copy of ``denseretrievaltoolkits_tpu/data/loaders.py``, with
the same names and behaviour. ``CorpusDataloader(shard_hosts=True)`` takes
this process's contiguous window of the corpus
(``utils/distributed.py:host_corpus_bounds``), the rows its rank of a sharded
index holds.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = False,
        drop_last: Optional[bool] = None,
        seed: int = 0,
        shard_num: int = 1,
        shard_idx: int = 0,
        shard_bounds: Optional[tuple] = None,
        sort_by_length: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.shard_num = shard_num
        self.shard_idx = shard_idx
        # length-grouped iteration (bucketed encode): examples ordered by
        # sort_by_length(example) so each batch is length-homogeneous and a
        # bucketing collator pads to the batch's own bucket. Applied AFTER
        # shard slicing (each shard sorts its own rows). Deterministic
        # (stable sort), so downstream docid <-> row mappings reproduce.
        self.sort_by_length = sort_by_length
        if sort_by_length is not None:
            assert not shuffle, "sort_by_length and shuffle are exclusive"
        self.length_sorted = sort_by_length is not None
        # contiguous [start, stop) row window (multi-host corpus encode, where
        # the window must match the device-sharded index placement —
        # utils.distributed.host_corpus_bounds); mutually exclusive with the
        # strided shard_num/shard_idx mode
        self.shard_bounds = shard_bounds
        if shard_bounds is not None:
            assert shard_num == 1, "shard_bounds and shard_num are exclusive"
            assert not shuffle, "shard_bounds requires a deterministic order"
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle per epoch (the reference's sampler.set_epoch,
        ``trainer.py:142-143``)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.shard_bounds is not None:
            start, stop = self.shard_bounds
            idx = idx[start:stop]
        elif self.shard_num > 1:
            # equal-length shards (the reference DistributedSampler's padding
            # semantics, DRT/dataloader/exactmatch_dataloader.py:17-25): pad
            # with wrap-around rows so every process yields exactly
            # ceil(n/shard_num) rows and therefore the SAME number of batches:
            # an unequal count would leave one process waiting in an extra
            # collective on the last batch.
            total = -(-n // self.shard_num) * self.shard_num
            if total > n:
                idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.shard_idx :: self.shard_num]
        if self.sort_by_length is not None:
            if not hasattr(self, "_len_cache"):
                # one host pass over the rows; cached — cheap next to the
                # tokenization the collator will do for the same rows
                self._len_cache = np.fromiter(
                    (self.sort_by_length(self.dataset[int(i)]) for i in idx),
                    dtype=np.int64, count=len(idx))
            idx = idx[np.argsort(self._len_cache, kind="stable")]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = self._indices()
        n_full = len(idx) // self.batch_size
        for b in range(n_full):
            rows = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in rows])
        rem = len(idx) - n_full * self.batch_size
        if rem and not self.drop_last:
            rows = idx[n_full * self.batch_size :]
            yield self.collate_fn([self.dataset[int(i)] for i in rows])


def pad_to_batch(batch_arrays: dict, batch_size: int):
    """Pad a final partial batch dict up to ``batch_size`` rows; returns
    (padded, valid_count). Use for eval/corpus encode steps to keep one
    batch shape."""
    valid = next(iter(batch_arrays.values())).shape[0]
    if valid == batch_size:
        return batch_arrays, valid
    out = {}
    for k, v in batch_arrays.items():
        pad_rows = np.zeros((batch_size - valid,) + v.shape[1:], dtype=v.dtype)
        out[k] = np.concatenate([v, pad_rows], axis=0)
    return out, valid


class PrefetchIterator:
    """Background-thread prefetch over a batch iterator.

    Host-side collation (tokenizer.prepare_for_model + numpy padding) runs in
    a worker thread while the device executes the previous step, so the input
    pipeline overlaps compute — the torch-DataLoader ``num_workers`` role,
    one thread being enough since batches are cheap relative to device steps.
    """

    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as exc:  # surface in the consumer thread
                self._err = exc
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth)


# ---------------------------------------------------------------------------
# Factory classes mirroring DRT/dataloader/*.py public surfaces
# ---------------------------------------------------------------------------

from .collators import (  # noqa: E402
    EncodeCollator,
    EVCollator,
    EVRRCollator,
    PPCollator,
    QPCollator,
    RRCollator,
)


class ExactMatchDataloader:
    """Train/eval/test loaders for answer-labeled datasets
    (reference ``DRT/dataloader/exactmatch_dataloader.py:8-151``)."""

    def __init__(self, data_args, dataset, tokenizer, neg_sampler,
                 batch_size: Sequence[int] = (1, 1, 1), seed: int = 0,
                 shard_num: int = 1, shard_idx: int = 0):
        self.data_args = data_args
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.neg_sampler = neg_sampler
        self.batch_size = list(batch_size)
        self.seed = seed
        self.shard_num = shard_num
        self.shard_idx = shard_idx

    def get_dataset(self):
        self.train_dataset, self.eval_dataset, self.test_dataset = self.dataset.load_train()

    def _loader(self, ds, bs, collator, shuffle, sharded: bool = True):
        # only TRAIN loaders shard across hosts (the reference's
        # DistributedSampler pick, exactmatch_dataloader.py:17-25); eval/test
        # query batches stay replicated — every process feeds the search the
        # same global query batch
        num, idx = (self.shard_num, self.shard_idx) if sharded else (1, 0)
        return DataLoader(ds, bs, collator, shuffle=shuffle, seed=self.seed,
                          shard_num=num, shard_idx=idx)

    def get_dataloader(self):
        if not hasattr(self, "train_dataset"):
            self.get_dataset()
        qp = QPCollator(self.data_args, self.neg_sampler, self.tokenizer)
        ev = EVCollator(self.data_args, self.tokenizer)
        return (
            self._loader(self.train_dataset, self.batch_size[0], qp, True),
            self._loader(self.eval_dataset, self.batch_size[1], ev, False, sharded=False),
            self._loader(self.test_dataset, self.batch_size[2], ev, False, sharded=False),
        )

    def get_bm25dataloader(self, dataset):
        """Train loader over the BM25-mined dataset (exactmatch_dataloader.py:30-42)."""
        qp = QPCollator(self.data_args, self.neg_sampler, self.tokenizer)
        return self._loader(dataset, self.batch_size[0], qp, True)

    def get_rr_dataloader(self):
        if not hasattr(self, "train_dataset"):
            self.get_dataset()
        rr = RRCollator(self.data_args, self.neg_sampler, self.tokenizer)
        return self._loader(self.train_dataset, self.batch_size[0], rr, True)

    def get_query_dataloader(self):
        ds = self.dataset.load_query_data()
        enc = EncodeCollator(self.tokenizer, q_max_len=self.data_args.q_max_len)
        return self._loader(ds, self.batch_size[0], enc, False)

    def get_corpus_dataloader(self, batch_size: int):
        ds = self.dataset.load_corpus_data()
        bucketed = bool(getattr(self.data_args, "bucketed_encode", False))
        if bucketed and self.shard_num > 1:
            raise ValueError("bucketed_encode is single-host only (see "
                             "CorpusDataloader)")
        step = int(getattr(self.data_args, "bucket_step", 32) or 32)
        pp = PPCollator(self.data_args, self.tokenizer,
                        bucket_step=step if bucketed else 0)
        loader = self._loader(ds, batch_size, pp, False, sharded=False)
        if bucketed:
            loader.sort_by_length = lambda ex: len(ex["text"]) + 2
            loader.length_sorted = True
        return loader


class RelevancyDataloader(ExactMatchDataloader):
    """MS MARCO-style relevancy-judged datasets
    (reference ``DRT/dataloader/relevancy_dataloader.py:27-66``)."""


class CorpusDataloader:
    """Sequential corpus-passage loader (reference ``corpus_dataloader.py:27-39``).

    Exposes ``.dataset`` so the evaluation loop can look up original passage
    text by row index (``trainer.py:307``)."""

    def __init__(self, data_args, dataset, tokenizer, batch_size: int = 128,
                 shard_num: int = 1, shard_idx: int = 0,
                 shard_hosts=False, bucketed: Optional[bool] = None):
        self.data_args = data_args
        self.corpus = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.shard_num = shard_num
        self.shard_idx = shard_idx
        # multi-host: each host encodes the contiguous corpus window matching
        # its devices' shards of the global index (host_corpus_bounds): True for
        # this rank's window of the process group, or a mesh's data axis as
        # (size, rank), whose model ranks encode the same window
        self.shard_hosts = shard_hosts
        # bucketed variable-length encode: length-sorted iteration + per-batch
        # bucket padding (collators.bucket_length). Single-host only: the
        # multi-host docid assembly reads ids in DATASET order
        # (train/trainer.py `loader.dataset["id"]`), which a sorted iteration
        # would silently mis-align with the per-host index windows.
        if bucketed is None:
            bucketed = bool(getattr(data_args, "bucketed_encode", False))
        if bucketed and (shard_hosts or shard_num > 1):
            raise ValueError(
                "bucketed_encode is single-host only: multi-host corpus "
                "encode maps docids by dataset order, which length-sorted "
                "iteration would break")
        self.bucketed = bucketed

    def get_dataloader(self):
        self.dataset = self.corpus.load_dataset()
        step = int(getattr(self.data_args, "bucket_step", 32) or 32)
        pp = PPCollator(self.data_args, self.tokenizer,
                        bucket_step=step if self.bucketed else 0)
        bounds = None
        if self.shard_hosts:
            from ..utils.distributed import host_corpus_bounds

            axis = self.shard_hosts if isinstance(self.shard_hosts, tuple) else (None, None)
            bounds = host_corpus_bounds(len(self.dataset), *axis)
        # sort key: pre-tokenized passage length (+2 covers [CLS]/[SEP];
        # exactness is irrelevant — any monotone proxy groups lengths)
        sort = (lambda ex: len(ex["text"]) + 2) if self.bucketed else None
        return DataLoader(self.dataset, self.batch_size, pp, shuffle=False,
                          shard_num=self.shard_num, shard_idx=self.shard_idx,
                          shard_bounds=bounds, sort_by_length=sort)

    # reference spelling (corpus_dataloader.py `get_dataloder`) kept as alias
    get_dataloder = get_dataloader


class RerankerDataloader:
    """Loader over the dense retriever's dump for cross-encoder eval
    (reference ``reranker_dataloader.py:26-40``)."""

    def __init__(self, data_args, dataset, tokenizer, batch_size: int = 128):
        self.data_args = data_args
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size

    def get_eval_dataloader(self):
        ds = self.dataset.load_dataset()
        # bucketed variable-length pairs: RRTrainer.evaluate groups scores by
        # qid, so the length-sorted iteration is transparent
        bucketed = bool(getattr(self.data_args, "bucketed_encode", False))
        step = int(getattr(self.data_args, "bucket_step", 32) or 32)
        collator = EVRRCollator(self.data_args, self.tokenizer,
                                bucket_step=step if bucketed else 0)
        # pair length proxy: tokens of both sides + [CLS]/[SEP]/[SEP]
        sort = ((lambda ex: len(ex["query"]) + len(ex["document"]) + 3)
                if bucketed else None)
        return DataLoader(ds, self.batch_size, collator, shuffle=False,
                          sort_by_length=sort)

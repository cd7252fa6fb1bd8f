"""Dataset layer (L2): HF datasets ingestion + tokenize-time preprocessing.

Mirrors ``DRT/dataset/abstract_dataset.py`` / ``CorpusDataset.py`` /
``reranker_dataset.py``: load train/dev/test splits with HF ``datasets``,
then run per-example tokenizing preprocessors through parallel
``datasets.map``.  All of this is host-side; device code only ever sees the
fixed-shape numpy batches produced by the collators.

The port's own copy of ``denseretrievaltoolkits_tpu/data/datasets.py``, with
the same names, registries and behaviour. Local JSON / JSON-Lines files (the
``json`` loader) are read by the port's own reader (``data/json_reader.py``),
which gives ``datasets``' rows; only a hub name goes through ``datasets``,
imported there.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

from .json_reader import is_local, load_json
from .preprocess import (
    CorpusPreProcessor,
    DocPreProcessor,
    EvalPreProcessor,
    ExactMatchPreProcessor,
    QueryPreProcessor,
    RelevancyPreProcessor,
    RREVPreProcessor,
    TrainPreProcessor,
)

# Registries (reference abstract_dataset.py:11-12)
RELEVANCY_DATASET = ["msmarco"]
EXACTMATCH_DATASET = ["nq", "wq", "tq", "squad"]


def load_dataset(name: str, data_files=None, cache_dir: Optional[str] = None):
    """``{split: rows}`` of a dataset: local ``json`` files through the port's
    reader, anything else through ``datasets.load_dataset`` (which must then be
    installed)."""
    if name == "json" and is_local(data_files):
        return load_json(data_files)
    try:
        import datasets
    except ImportError as exc:
        raise ImportError(f"dataset {name!r} (data_files={data_files!r}) is no set of local "
                          "JSON files: it needs `datasets`, which is not installed") from exc
    return datasets.load_dataset(name, data_files=data_files, cache_dir=cache_dir)


def _num_proc(requested: int, n_rows: int) -> Optional[int]:
    """datasets.map errors when num_proc > shards; clamp for small datasets."""
    n = min(requested, max(1, n_rows // 64))
    return n if n > 1 else None


class AbstractDataset:
    """Split loading + preprocessor mapping (abstract_dataset.py:15-140)."""

    def __init__(self, data_args, tokenizer, cache_dir: str = None):
        self.cache_dir = cache_dir
        self.dataset = load_dataset(
            data_args.dataset_name,
            data_files=data_args.data_path,
            cache_dir=self.cache_dir,
        )
        self.train_dataset = self.dataset["train"]
        self.valid_dataset = self.dataset["dev"]
        self.test_dataset = self.dataset["test"]
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.q_max_len = data_args.q_max_len
        self.p_max_len = data_args.p_max_len
        self.proc_num = data_args.dataset_proc_num
        self.neg_num = data_args.train_n_passages - 1
        self.separator = getattr(
            tokenizer, data_args.passage_field_separator, data_args.passage_field_separator
        )
        self.has_load_train = False

    # the dev/test preprocessor; ExactMatch keeps answers for string matching,
    # Relevancy keeps positive docids for judged evaluation
    _eval_preprocessor_cls = ExactMatchPreProcessor

    def _map(self, ds, preprocessor, desc):
        return ds.map(
            preprocessor,
            batched=False,
            num_proc=_num_proc(self.proc_num, len(ds)),
            remove_columns=ds.column_names,
            desc=desc,
        )

    def load_train(self, shard_num: int = 1, shard_idx: int = 0):
        """Tokenize train with TrainPreProcessor and dev/test with the eval
        preprocessor (abstract_dataset.py:66-94)."""
        if self.has_load_train:
            return self.train_dataset, self.valid_dataset, self.test_dataset
        self.has_load_train = True
        self.train_dataset = self._map(
            self.train_dataset.shard(shard_num, shard_idx),
            TrainPreProcessor(self.tokenizer, self.q_max_len, self.p_max_len, self.separator),
            "Tokenizing train",
        )
        eval_pre = self._eval_preprocessor_cls(self.tokenizer, self.q_max_len)
        self.valid_dataset = self._map(
            self.valid_dataset.shard(shard_num, shard_idx), eval_pre, "Tokenizing dev"
        )
        self.test_dataset = self._map(
            self.test_dataset.shard(shard_num, shard_idx), eval_pre, "Tokenizing test"
        )
        return self.train_dataset, self.valid_dataset, self.test_dataset

    def load_query_data(self, shard_num: int = 1, shard_idx: int = 0):
        ds = self.test_dataset.shard(shard_num, shard_idx)
        return self._map(ds, QueryPreProcessor(self.tokenizer, self.q_max_len), "Tokenizing queries")

    def load_BM25_data(self, shard_num: int = 1, shard_idx: int = 0):
        self.load_train(shard_num, shard_idx)
        return self.train_dataset

    def load_corpus_data(self, shard_num: int = 1, shard_idx: int = 0):
        self.corpus = load_dataset(
            self.data_args.corpus_name,
            data_files=self.data_args.corpus_path,
            cache_dir=self.cache_dir,
        )["train"].shard(shard_num, shard_idx)
        return self._map(
            self.corpus,
            CorpusPreProcessor(self.tokenizer, self.p_max_len, self.separator),
            "Tokenizing corpus",
        )

    def load_id_text(self):
        """docid → token-id map over the corpus (abstract_dataset.py:125-136)."""
        corpus_data = self.load_corpus_data()
        return {c["id"]: c["text"] for c in corpus_data}


class ExactMatchDataset(AbstractDataset):
    """NQ/WQ/TriviaQA/SQuAD-style answer-labeled datasets
    (abstract_dataset.py:190-234)."""

    _eval_preprocessor_cls = ExactMatchPreProcessor

    def process(self, shard_num: int = 1, shard_idx: int = 0):
        ds = self.train_dataset.shard(shard_num, shard_idx)
        return self._map(
            ds, ExactMatchPreProcessor(self.tokenizer, self.q_max_len), "Tokenizing train"
        )


class RelevancyDataset(AbstractDataset):
    """MS MARCO-style relevancy-judged datasets (abstract_dataset.py:143-187).

    dev/test keep positive docids (EvalPreProcessor) so evaluation labels hits
    by docid membership instead of answer-string matching — the intended
    semantics of the msmarco registry entry (the reference mapped
    ExactMatchPreProcessor, which requires an ``answers`` field MS MARCO
    doesn't have)."""

    _eval_preprocessor_cls = EvalPreProcessor

    def process(self, shard_num: int = 1, shard_idx: int = 0):
        ds = self.train_dataset.shard(shard_num, shard_idx)
        return self._map(
            ds, RelevancyPreProcessor(self.tokenizer, self.q_max_len), "Tokenizing train"
        )


class CorpusDataset:
    """Standalone retrieval-corpus loader (reference ``CorpusDataset.py:8-31``).

    The reference hardcodes ``{cache}/wiki/corpus.json``; here ``corpus_path``
    (or ``corpus_name`` for a hub dataset) comes from DataArguments.  Chooses
    the title-aware CorpusPreProcessor when rows have ``docid`` (hub corpora
    like xxazz/nq-corpus) and DocPreProcessor for bare {id, text} rows."""

    def __init__(self, data_args, tokenizer, cache_dir: str = None):
        self.data_args = data_args
        self.tokenizer = tokenizer
        self.cache_dir = cache_dir
        self.p_max_len = data_args.p_max_len
        self.proc_num = data_args.dataset_proc_num

    def load_dataset(self, shard_num: int = 1, shard_idx: int = 0):
        corpus = load_dataset(
            self.data_args.corpus_name,
            data_files=self.data_args.corpus_path,
            cache_dir=self.cache_dir,
        )["train"].shard(shard_num, shard_idx)
        if "docid" in corpus.column_names:
            pre = CorpusPreProcessor(
                self.tokenizer, self.p_max_len, self.data_args.passage_field_separator
            )
        else:
            pre = DocPreProcessor(self.tokenizer, self.p_max_len)
        return corpus.map(
            pre,
            batched=False,
            num_proc=_num_proc(self.proc_num, len(corpus)),
            remove_columns=corpus.column_names,
            desc="Tokenizing corpus",
        )


class RRDataset:
    """Reranker-eval dataset over the dense retriever's dump directory
    (reference ``reranker_dataset.py:7-35``) — the dense→rerank handoff."""

    def __init__(self, data_args, training_args, tokenizer, cache_dir: str = None):
        self.data_args = data_args
        self.retrieve_dir = training_args.retrieve_dir
        self.tokenizer = tokenizer
        self.cache_dir = cache_dir

    def load_dataset(self):
        files = sorted(glob.glob(os.path.join(self.retrieve_dir, "*.json")))
        if not files:
            raise FileNotFoundError(f"no retrieval dumps in {self.retrieve_dir}")
        ds = load_dataset("json", data_files=files, cache_dir=self.cache_dir)["train"]
        pre = RREVPreProcessor(self.tokenizer, self.data_args.q_max_len, self.data_args.p_max_len)
        return ds.map(
            pre,
            batched=False,
            num_proc=_num_proc(self.data_args.dataset_proc_num, len(ds)),
            remove_columns=ds.column_names,
            desc="Tokenizing rerank pairs",
        )

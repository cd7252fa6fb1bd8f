"""The port's copies of the data layer held to their originals, on the CPU.

``data.datasets``, ``data.preprocess``, ``data.samplers`` and ``utils``
(``tokenization``,
``distributed``, ``runtime``), by the pattern of ``tests/test_torch_shared.py``:
the same inputs through both, the same outputs exactly. The datasets and the
tokenizer are the local ones of ``tests/helpers.py`` (no network).
"""

import random

import numpy as np
import pytest
import torch

from denseretrievaltoolkits_tpu.config import DataArguments, ModelArguments
from denseretrievaltoolkits_tpu.data import datasets as jds
from denseretrievaltoolkits_tpu.data import preprocess as jpre
from denseretrievaltoolkits_tpu.data import samplers as jsam
from denseretrievaltoolkits_tpu.utils import tokenization as jtok
from denseretrievaltoolkits_torch.data import datasets as tds
from denseretrievaltoolkits_torch.data import preprocess as tpre
from denseretrievaltoolkits_torch.data import samplers as tsam
from denseretrievaltoolkits_torch.utils import distributed as tdist
from denseretrievaltoolkits_torch.utils import runtime as truntime
from denseretrievaltoolkits_torch.utils import tokenization as ttok

from helpers import make_exactmatch_dataset, make_tokenizer


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    tokenizer = make_tokenizer(tmp)
    tok_dir = str(tmp / "tok")
    tokenizer.save_pretrained(tok_dir)
    data_dir, corpus_path, splits, corpus_rows = make_exactmatch_dataset(
        tmp, random.Random(1), n_train=12, n_eval=6, n_corpus=40, n_neg=3)
    return dict(tmp=tmp, tokenizer=tokenizer, tok_dir=tok_dir, data_dir=data_dir,
                corpus_path=corpus_path, splits=splits, corpus_rows=corpus_rows)


def _data_args(d, side):
    return DataArguments(dataset="nq", data_dir=d["data_dir"], corpus_path=d["corpus_path"],
                         train_n_passages=3, q_max_len=12, p_max_len=20,
                         data_cache_dir=str(d["tmp"] / f"hf-{side}"))


def _rows(ds):
    return [dict(r) for r in ds]


def test_registries_match():
    assert tds.RELEVANCY_DATASET == jds.RELEVANCY_DATASET
    assert tds.EXACTMATCH_DATASET == jds.EXACTMATCH_DATASET


def test_exactmatch_and_corpus_datasets_give_the_same_rows(data):
    """``load_train`` (train, dev, test), ``process``, ``load_query_data`` and
    ``CorpusDataset.load_dataset`` from ``make_exactmatch_dataset`` rows."""
    tok = data["tokenizer"]
    j = jds.ExactMatchDataset(_data_args(data, "j"), tok, cache_dir=str(data["tmp"] / "hf-j"))
    t = tds.ExactMatchDataset(_data_args(data, "t"), tok, cache_dir=str(data["tmp"] / "hf-t"))
    assert _rows(j.process()) == _rows(t.process())  # on the raw rows: before load_train
    assert _rows(j.load_query_data()) == _rows(t.load_query_data())
    for a, b in zip(j.load_train(), t.load_train()):
        assert _rows(a) == _rows(b) and len(a) > 0
    jc = jds.CorpusDataset(_data_args(data, "j"), tok, str(data["tmp"] / "hf-j")).load_dataset()
    tc = tds.CorpusDataset(_data_args(data, "t"), tok, str(data["tmp"] / "hf-t")).load_dataset()
    assert _rows(jc) == _rows(tc) and len(tc) == len(data["corpus_rows"])


def test_relevancy_dataset_gives_the_same_rows(data):
    """``RelevancyDataset.load_train``: dev / test keep their positive
    docids."""
    tok = data["tokenizer"]
    j = jds.RelevancyDataset(_data_args(data, "j"), tok, cache_dir=str(data["tmp"] / "hf-j"))
    t = tds.RelevancyDataset(_data_args(data, "t"), tok, cache_dir=str(data["tmp"] / "hf-t"))
    for a, b in zip(j.load_train(), t.load_train()):
        assert _rows(a) == _rows(b) and len(a) > 0
    assert "positives_ids" in _rows(t.valid_dataset)[0]


@pytest.mark.parametrize("shard_idx", [0, 1])
def test_sharded_rows_match(data, shard_idx):
    """``load_train`` and ``load_query_data`` on one of two shards."""
    tok = data["tokenizer"]
    j = jds.ExactMatchDataset(_data_args(data, "j"), tok, cache_dir=str(data["tmp"] / "hf-j"))
    t = tds.ExactMatchDataset(_data_args(data, "t"), tok, cache_dir=str(data["tmp"] / "hf-t"))
    assert _rows(j.load_query_data(2, shard_idx)) == _rows(t.load_query_data(2, shard_idx))
    for a, b, split in zip(j.load_train(2, shard_idx), t.load_train(2, shard_idx),
                           ("train", "dev", "test")):
        assert _rows(a) == _rows(b) and len(b) == len(data["splits"][split]) // 2


def test_id_text_and_bm25_data_match(data):
    """``load_id_text`` (docid -> token ids over the corpus) and
    ``load_BM25_data`` (the tokenized train split)."""
    tok = data["tokenizer"]
    j = jds.ExactMatchDataset(_data_args(data, "j"), tok, cache_dir=str(data["tmp"] / "hf-j"))
    t = tds.ExactMatchDataset(_data_args(data, "t"), tok, cache_dir=str(data["tmp"] / "hf-t"))
    id_text = t.load_id_text()
    assert id_text == j.load_id_text() and len(id_text) == len(data["corpus_rows"])
    assert _rows(t.load_BM25_data()) == _rows(j.load_BM25_data())


# each preprocessor's arguments after the tokenizer: (query max len, text max len, separator)
PREPROCESSORS = {"TrainPreProcessor": (6, 9, " | "), "EvalPreProcessor": (6, 9),
                 "DocPreProcessor": (9,), "RREVPreProcessor": (6, 9),
                 "RelevancyPreProcessor": (6,), "ExactMatchPreProcessor": (6,),
                 "QueryPreProcessor": (6,), "CorpusPreProcessor": (9, " | ")}


@pytest.mark.parametrize("name", sorted(PREPROCESSORS))
def test_preprocessors_match(data, name):
    """Every preprocessor on one example carrying every field any reads."""
    row = dict(data["splits"]["train"][0])
    doc = data["corpus_rows"][0]
    row.update(id=doc["docid"], docid=doc["docid"], title=doc["title"], text=doc["text"],
               document=doc["text"], doc_id=doc["docid"], pos_doc_ids=[doc["docid"]])
    args = (data["tokenizer"],) + PREPROCESSORS[name]
    want = getattr(jpre, name)(*args)(row)
    assert getattr(tpre, name)(*args)(row) == want and want


@pytest.mark.parametrize("pos_fixed,neg_fixed", [(False, False), (True, True), (False, True)])
def test_random_sample_negatives_same_draws(pos_fixed, neg_fixed):
    """The same positives and negatives for a seed over several batches."""
    rng = np.random.default_rng(4)
    samples = [{"query": rng.integers(0, 50, 4).tolist(),
                "positives": [rng.integers(0, 50, 6).tolist() for _ in range(3)],
                "negatives": [rng.integers(0, 50, 6).tolist() for _ in range(5)]}
               for _ in range(8)]
    args = DataArguments(train_n_passages=4, positive_passage_no_shuffle=pos_fixed,
                         negative_passage_no_shuffle=neg_fixed)
    j, t = jsam.RandomSampleNegatives(args, seed=11), tsam.RandomSampleNegatives(args, seed=11)
    for lo in range(0, 8, 3):
        assert t(samples[lo:lo + 3]) == j(samples[lo:lo + 3])
    with pytest.raises(ValueError, match="need 3 negatives"):
        t([{"query": [1], "positives": [[2]], "negatives": [[3]]}])


def test_bm25_negatives_is_a_later_slice(data, tmp_path):
    """``BM25Negatives`` is ported (the native engine and the cache file against the
    JAX package's: tests/test_torch_mining.py): on the tokenized train split, the
    Python retriever's mined rows equal the JAX package's, and collate-time sampling
    draws as its sampler does."""
    train = _rows(jds.ExactMatchDataset(_data_args(data, "jax"), data["tokenizer"]
                                        ).load_train()[0])
    out = []
    for mod in (jsam, tsam):
        args = DataArguments(train_n_passages=3, data_cache_dir=str(tmp_path / mod.__name__))
        sampler = mod.BM25Negatives(args, vocab_size=data["tokenizer"].vocab_size, seed=2,
                                    use_native=False)
        mined = sampler.load_passages(train)
        out.append((mined, sampler(mined[:4])))
    assert out[1] == out[0] and len(out[0][0]) == 12


def test_utils(data):
    """``load_tokenizer`` loads the same tokenizer; ``process_shard`` is one
    process; ``setup_runtime`` resolves the device it is given."""
    args = ModelArguments(tokenizer_name=data["tok_dir"])
    text = "what is the capital of france"
    assert ttok.load_tokenizer(args).encode(text) == jtok.load_tokenizer(args).encode(text)
    assert tdist.process_shard() == (1, 0)
    assert truntime.setup_runtime("cpu") == torch.device("cpu")

"""The port's own copies of the modules it shares with the JAX package, held
to their originals: ``config``, ``data.collators``, ``data.loaders``,
``evaluator.metrics``, ``index.modes``, ``evaluator.bm25``, ``evaluator.trec``,
``evaluator.convert``, ``utils.distributed``'s corpus bounds and the native BM25 engine's source ``native/bm25.cpp``
(byte for byte). Same fields and defaults, the same parse of the same argv, the same batches, loader order, metrics and mode
resolution (raises included). Inputs are seeded numpy; everything compares
exactly."""

import dataclasses
import itertools
import json
import pathlib
import random

import numpy as np
import pytest

from denseretrievaltoolkits_tpu import config as jconfig
from denseretrievaltoolkits_tpu.data import collators as jcol
from denseretrievaltoolkits_tpu.data import loaders as jload
from denseretrievaltoolkits_tpu.evaluator import bm25 as jbm25
from denseretrievaltoolkits_tpu.evaluator import convert as jconvert
from denseretrievaltoolkits_tpu.evaluator import metrics as jmet
from denseretrievaltoolkits_tpu.evaluator import trec as jtrec
from denseretrievaltoolkits_tpu.index import modes as jmodes
from denseretrievaltoolkits_tpu.utils import distributed as jdist
from denseretrievaltoolkits_torch import config as tconfig
from denseretrievaltoolkits_torch.data import collators as tcol
from denseretrievaltoolkits_torch.data import loaders as tload
from denseretrievaltoolkits_torch.evaluator import bm25 as tbm25
from denseretrievaltoolkits_torch.evaluator import convert as tconvert
from denseretrievaltoolkits_torch.evaluator import metrics as tmet
from denseretrievaltoolkits_torch.evaluator import trec as ttrec
from denseretrievaltoolkits_torch.index import modes as tmodes
from denseretrievaltoolkits_torch.utils import distributed as tdist

CLASSES = ["ModelArguments", "DataArguments", "TrainingArguments", "RRTrainingArguments"]


def _defaults(dc):
    out = []
    for f in dataclasses.fields(dc):
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        out.append((f.name, str(f.type), default))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults(name):
    assert _defaults(getattr(tconfig, name)) == _defaults(getattr(jconfig, name))


def _parsed(module, argv):
    triple = (module.ModelArguments, module.DataArguments, module.TrainingArguments)
    return [dataclasses.asdict(x) for x in module.parse_args(triple, args=argv)]


def test_parse_args_same_argv(tmp_path):
    argv = ["--model_name_or_path", "m", "--dtype", "bfloat16", "--attention", "fused",
            "--fused_loss", "--no_negatives_x_device", "--encode_in_path", "a.jsonl", "b.jsonl",
            "--q_max_len", "16", "--optimizer_kwargs", '{"eps": 1e-6}', "--index_dtype", "int8",
            "--search_mode", "serve", "--index_slab_rows", "1024", "--topk", "1,5",
            "--cache_train_dir", str(tmp_path / "cache"), "--output_dir", str(tmp_path / "out")]
    assert _parsed(tconfig, argv) == _parsed(jconfig, argv)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"pooling": "mean", "train_n_passages": 4, "learning_rate": 3e-5,
                               "cache_train_dir": str(tmp_path / "cache2")}))
    assert _parsed(tconfig, [str(cfg)]) == _parsed(jconfig, [str(cfg)])


class _Tokenizer:
    """prepare_for_model as a BERT tokenizer does it: [CLS] a [SEP] (b [SEP]),
    the first text truncated."""

    pad_token_id = 0

    def prepare_for_model(self, a, b=None, truncation=None, max_length=None, padding=False,
                          return_attention_mask=False, return_token_type_ids=False):
        extra = 3 + len(b) if b is not None else 2
        a = list(a)[:max(0, max_length - extra)]
        ids = [101] + a + [102] + (list(b) + [102] if b is not None else [])
        return {"input_ids": ids}


def _seqs(seed, n=23, max_len=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(1000, 2000, int(L)).tolist()
            for L in rng.integers(1, max_len, n)]


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, tuple) and isinstance(b, tuple))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("bucket_step", [0, 8])
def test_pad_batch_and_collators(bucket_step):
    seqs = _seqs(0)
    _same(tcol.pad_batch(seqs, 32, 0, bucket_step), jcol.pad_batch(seqs, 32, 0, bucket_step))
    padded = jcol.pad_batch(seqs[:5], 32, 0)
    _same(tload.pad_to_batch(padded, 8), jload.pad_to_batch(padded, 8))
    assert tcol.bucket_length(13, 40, 8) == jcol.bucket_length(13, 40, 8)
    tok = _Tokenizer()
    docs = [{"doc_id": f"d{i}", "text": s} for i, s in enumerate(seqs)]
    queries = [{"query_id": f"q{i}", "query": s} for i, s in enumerate(seqs)]
    for feats, kw in ((docs, dict(p_max_len=24)), (queries, dict(q_max_len=12))):
        _same(tcol.EncodeCollator(tok, bucket_step=bucket_step, **kw)(feats),
              jcol.EncodeCollator(tok, bucket_step=bucket_step, **kw)(feats))


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=3), dict(shuffle=False),
                                dict(shuffle=False, drop_last=True),
                                dict(shuffle=True, seed=1, shard_num=3, shard_idx=2),
                                dict(shuffle=False, sort_by_length=len)])
def test_dataloader_order(kw):
    """The same batches in the same order, for two epochs, and through prefetch."""
    data = _seqs(1, n=47)

    def collate(rows):
        return jcol.pad_batch(rows, 40, 0)

    t = tload.DataLoader(data, 8, collate, **kw)
    j = jload.DataLoader(data, 8, collate, **kw)
    assert len(t) == len(j)
    for ep in (0, 1):
        t.set_epoch(ep)
        j.set_epoch(ep)
        _same(list(tload.prefetch(t)), list(j))


def test_get_metrics():
    rng = np.random.default_rng(2)
    hits = (rng.random((40, 30)) < 0.08).astype(np.int64)
    hits[0] = 0  # a query without a hit
    assert tmet.get_metrics(hits, [1, 5, 30]) == jmet.get_metrics(hits, [1, 5, 30])


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "ValueError", str(e).split("(")[0].split(";")[0][:20]


def test_resolve_mode_every_pair():
    assert tmodes.FLAT_MODES == jmodes.FLAT_MODES
    assert tmodes.APPROX_ALIAS == jmodes.APPROX_ALIAS
    assert (tmodes.IVF_MODES, tmodes.PQ_MODES, tmodes.IVFPQ_MODES) == \
        (jmodes.IVF_MODES, jmodes.PQ_MODES, jmodes.IVFPQ_MODES)
    dtypes = ("float32", "bfloat16", "int8", "int4")
    modes = ("exact", "serve", "partial", "i8q", "approx", "bulk", "probe", "nope")
    for mode, dtype in itertools.product(modes, dtypes):
        for name in ("resolve_mode", "resolve_ivf_mode"):
            got = _outcome(getattr(tmodes, name), mode, dtype)
            want = _outcome(getattr(jmodes, name), mode, dtype)
            assert got[0] == want[0], (name, mode, dtype, got, want)
            if got[0] == "ok":
                assert got == want
    for mode in modes:
        for name in ("resolve_pq_mode", "resolve_ivfpq_mode"):
            got, want = (_outcome(getattr(m, name), mode) for m in (tmodes, jmodes))
            assert got[0] == want[0] and (got[0] != "ok" or got == want), (name, mode)


def test_bm25_copies():
    """``native/bm25.cpp`` is a byte-for-byte copy in the port (built into its own
    ``_build/``, never from ``csrc/``, which the CUDA build hashes); ``BM25Retriever``
    gives the same spans, idfs, searches (random padding included) and ``retrieve``."""
    root = pathlib.Path(__file__).resolve().parents[1]
    port_src = root / "denseretrievaltoolkits_torch" / "native" / "bm25.cpp"
    assert port_src.read_bytes() == (root / "native" / "bm25.cpp").read_bytes()
    assert not list((root / "denseretrievaltoolkits_torch" / "csrc").glob("bm25*"))
    rng = random.Random(4)
    corpus = [{"positives": [[rng.randrange(60) for _ in range(rng.randrange(3, 12))]],
               "negatives": [[rng.randrange(60) for _ in range(rng.randrange(3, 12))]
                             for _ in range(rng.randrange(0, 4))]} for _ in range(25)]
    t, j = tbm25.BM25Retriever(topK=4, seed=9), jbm25.BM25Retriever(topK=4, seed=9)
    assert t.load_passages(corpus) == j.load_passages(corpus)
    assert t.idf == j.idf and t.avg_doc_len == j.avg_doc_len
    for _ in range(12):
        q = [rng.randrange(80) for _ in range(5)]
        assert t.search(q, 30) == j.search(q, 30)  # 30: past the matches, so it pads
        assert t.retrieve(q, corpus[0]["negatives"] + corpus[1]["positives"]) == \
            j.retrieve(q, corpus[0]["negatives"] + corpus[1]["positives"])


def test_trec_and_convert_copies(tmp_path):
    """``evaluator/trec.py`` and ``evaluator/convert.py``: the same names; the same TREC
    file, reads (6- and 3-column, ``as_list``, ``max_len_per_q``), shard merge and dump
    conversions (nq_eval JSON, TREC, with and without scores), byte for byte."""
    for t, j in ((ttrec, jtrec), (tconvert, jconvert)):
        assert sorted(n for n in vars(t) if not n.startswith("_")) == \
            sorted(n for n in vars(j) if not n.startswith("_"))
    rng = random.Random(6)
    runs = [{f"q{q}": {f"d{rng.randrange(40)}": round(rng.uniform(-3, 3), 4)
                       for _ in range(rng.randrange(1, 9))} for q in range(7)}
            for _ in range(3)]
    for m, name in ((ttrec, "port"), (jtrec, "jax")):
        m.save_as_trec(runs[0], str(tmp_path / f"{name}.trec"))
        m.save_as_trec(runs[1], str(tmp_path / f"{name}-id.trec"), run_id="x")
    for suffix in (".trec", "-id.trec"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()
    three = tmp_path / "three.run"
    three.write_text("".join(f"{q} {d} {s}\n" for q, ds in runs[2].items() for d, s in ds.items()))
    for path in (str(tmp_path / "jax.trec"), str(three)):
        for kw in (dict(), dict(as_list=True), dict(max_len_per_q=2)):
            assert ttrec.load_from_trec(path, **kw) == jtrec.load_from_trec(path, **kw)
    bad = tmp_path / "bad.run"
    bad.write_text("q1 d1\n")
    for m in (ttrec, jtrec):
        with pytest.raises(ValueError, match="Invalid run format"):
            m.load_from_trec(str(bad))
    assert ttrec.merge_retrieval_results_by_score(runs, topk=3) == \
        jtrec.merge_retrieval_results_by_score(runs, topk=3)
    dump = tmp_path / "dump.json"
    with open(dump, "w") as fh:
        for q in range(5):
            for r in range(4):
                row = {"doc_id": f"d{rng.randrange(30)}", "query_id": f"q{q}", "query": "x y",
                       "document": f"text {q} {r}", "answers": ["a"]}
                if q != 3:  # one query without scores: the rank-order fallback
                    row["score"] = round(rng.uniform(0, 9), 3)
                fh.write(json.dumps(row) + "\n")
    for m, name in ((tconvert, "port"), (jconvert, "jax")):
        assert m.retrieval_jsonl_to_nq_json(str(dump), str(tmp_path / f"{name}.nq.json")) == \
            jconvert.retrieval_jsonl_to_nq_json(str(dump))
        m.retrieval_jsonl_to_trec(str(dump), str(tmp_path / f"{name}.dump.trec"))
    for suffix in (".nq.json", ".dump.trec"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()


def test_distributed_copy():
    """``host_corpus_bounds`` over a grid of (rows, processes, process, local shards),
    and one process's ``process_shard``, as the JAX package's (utils/distributed.py:53-81
    there; the port drives one card a process, so its default ``local_shards`` is 1)."""
    for n, procs, shards in itertools.product((0, 1, 7, 96, 1001), (1, 2, 3, 8), (1, 2)):
        for p in range(procs):
            assert tdist.host_corpus_bounds(n, procs, p, shards) == jdist.host_corpus_bounds(
                n, n_proc=procs, proc_idx=p, local_shards=shards), (n, procs, p, shards)
    assert tdist.process_shard() == jdist.process_shard() == (1, 0)

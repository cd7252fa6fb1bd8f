"""Hard-negative mining of the port against the JAX package's, on the CPU.

``DenseMiner`` and the Trainer's ``mine_per_train`` hook: the same tiny
ExactMatch data (``helpers.make_exactmatch_dataset``) and the same weights in
both packages (seeded N(0, 0.3) noise on BERT's init, so the scores spread
beyond fp32 ties, as ``tests/test_torch_eval.py`` does); both search their
flat index by an exact scan here (the JAX package runs every mode as one off
the TPU), and the mined lists must be identical. BM25: the port's native
engine (its own copy of ``native/bm25.cpp``, built into ``_build/``) against
the Python retriever by score, and ``BM25Negatives`` and the
``run_BM25_negative`` twin against the JAX package's, down to the cache file.
"""

import glob
import json
import os
import random
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import run_BM25_negative as jax_bm25_entry
from denseretrievaltoolkits_tpu import config as jconfig
from denseretrievaltoolkits_tpu.data import loaders as jloaders
from denseretrievaltoolkits_tpu.data import samplers as jsam
from denseretrievaltoolkits_tpu.data.datasets import CorpusDataset, ExactMatchDataset
from denseretrievaltoolkits_tpu.mine.miner import DenseMiner as JaxMiner
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JaxTrainer
from denseretrievaltoolkits_torch import config as tconfig
from denseretrievaltoolkits_torch import run_BM25_negative as port_bm25_entry
from denseretrievaltoolkits_torch.data import loaders as tloaders
from denseretrievaltoolkits_torch.data import samplers as tsam
from denseretrievaltoolkits_torch.evaluator import bm25 as tbm25
from denseretrievaltoolkits_torch.evaluator import bm25_native as tnative
from denseretrievaltoolkits_torch.mine.miner import DenseMiner
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models.convert import params_to_jax
from denseretrievaltoolkits_torch.train.trainer import Trainer

from helpers import make_exactmatch_dataset, make_tokenizer


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mining")
    tokenizer = make_tokenizer(tmp)
    data_dir, corpus_path, splits, _ = make_exactmatch_dataset(
        tmp, random.Random(0), n_train=16, n_eval=8, n_corpus=48, n_neg=4)
    kw = dict(data_dir=data_dir, corpus_path=corpus_path, train_n_passages=3, q_max_len=16,
              p_max_len=24, data_cache_dir=str(tmp / "hfcache"))
    jdata, tdata = jconfig.DataArguments(**kw), tconfig.DataArguments(**kw)
    dataset = ExactMatchDataset(jdata, tokenizer)
    train = list(dataset.load_train()[0])
    corpus = CorpusDataset(jdata, tokenizer)
    cfg = dict(vocab_size=tokenizer.vocab_size, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64, max_position_embeddings=48)
    docids = [{p["docid"] for p in row["positive_passages"]} for row in splits["train"]]
    return dict(tmp=tmp, tokenizer=tokenizer, jdata=jdata, tdata=tdata, dataset=dataset,
                train=train, corpus=corpus, cfg=cfg, docids=docids)


def _targs(module, tmp, name, **kw):
    base = dict(output_dir=str(tmp / name / "out"), cache_train_dir=str(tmp / name / "cache"),
                train_batch_size=4, eval_batch_size=4, corpus_batch_size=8, max_epochs=2,
                eval_per_train=1, save_per_train=10, learning_rate=1e-3, optimizer="adamw",
                topk="1,5", retrieve_num=5, log_every=1, index_slab_rows=16, mine_per_train=1)
    base.update(kw)
    return module.TrainingArguments(**base)


def _pair(d, name, with_eval=True, **kw):
    """A JAX Trainer and a port Trainer over the same weights and data, each with its
    package's DenseMiner attached."""
    port = tbi.DRModel.build(tconfig.ModelArguments(), bert_config=tbert.BertConfig(**d["cfg"]),
                             seed=11, device="cpu")
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for prm in port.parameters():
            prm.add_(torch.from_numpy(0.3 * rng.standard_normal(prm.shape).astype(np.float32)))
    jmodel = jbi.DRModel(jbi.DRModelSpec(bert_config=jbert.BertConfig(**d["cfg"])))
    jparams = jax.tree.map(jnp.asarray, {"lm_q": params_to_jax(port.lm_q.state_dict())})
    out = []
    for loaders, config, dargs in ((jloaders, jconfig, d["jdata"]), (tloaders, tconfig,
                                                                     d["tdata"])):
        factory = loaders.ExactMatchDataloader(dargs, d["dataset"], d["tokenizer"],
                                               jsam.RandomSampleNegatives(dargs, seed=0),
                                               batch_size=[4, 4, 4])
        train, ev, _ = factory.get_dataloader()
        corpus = loaders.CorpusDataloader(dargs, d["corpus"], d["tokenizer"],
                                          batch_size=8).get_dataloader()
        out.append(dict(args=_targs(config, d["tmp"], f"{name}-{config.__name__}", **kw),
                        train=train, eval=ev if with_eval else None, corpus=corpus))
    j, t = out
    jtrainer = JaxTrainer(j["args"], jmodel, jparams, corpus_dataloader=j["corpus"],
                          train_loader=j["train"], eval_loader=j["eval"])
    jtrainer.miner = JaxMiner(jtrainer, d["tokenizer"], d["jdata"], search_mode="exact")
    ttrainer = Trainer(t["args"], port, corpus_dataloader=t["corpus"], train_loader=t["train"],
                       eval_loader=t["eval"])
    ttrainer.miner = DenseMiner(ttrainer, d["tokenizer"], d["tdata"], search_mode="exact")
    return jtrainer, ttrainer


@pytest.mark.parametrize("by", ["tokens", "docids"])
def test_dense_miner_matches_jax(data, by):
    """The port's and the JAX package's miners over their own index of the same reps:
    identical mined rows, own positives excluded (by token list, or by docid)."""
    jtrainer, ttrainer = _pair(data, f"miner-{by}")
    jtrainer._encoding_corpus(0)
    ttrainer._encoding_corpus(0)
    docids = data["docids"] if by == "docids" else None
    want = jtrainer.miner.mine(data["train"], docids)
    got = ttrainer.miner.mine(data["train"], docids)
    assert got == want and len(got) == 16
    refreshed = sum(g["negatives"] != s["negatives"] for g, s in zip(got, data["train"]))
    assert refreshed >= 12
    for row, sample, own in zip(got, data["train"], data["docids"]):
        assert len(row["negatives"]) == 2
        if by == "tokens":
            assert not {tuple(n) for n in row["negatives"]} & {tuple(p) for p in
                                                               sample["positives"]}
    assert ttrainer.miner.search_mode == "exact" and DenseMiner(
        ttrainer, data["tokenizer"], data["tdata"]).search_mode == "serve"


class _Index:
    """A stand-in index: fixed rows with -1 sentinels."""

    def __init__(self, rows):
        self.rows = np.asarray(rows)

    def __len__(self):
        return 6

    def batch_search(self, q_reps, k, batch_size, quiet, mode):
        assert (k, batch_size, quiet, mode) == (4, 256, True, "serve")
        assert q_reps.shape == (len(self.rows), 8)
        return np.zeros(self.rows.shape, np.float32), self.rows[:, :k]


def test_sentinel_exclusion_and_refusals(data):
    """-1 rows are skipped (never ``idx[-1]``), own docids excluded, index rows mapped
    through ``_row2ds``; a sample short of negatives keeps its own; an unbuilt index or
    a corpus without a dataset raises."""
    docs = [{"text": [10 + i, 20 + i]} for i in range(6)]
    model = types.SimpleNamespace(encode_query=lambda b: torch.zeros(b["input_ids"].shape[0], 8))
    trainer = types.SimpleNamespace(
        model=model, index=_Index([[-1, 2, 0, 5], [3, -1, -1, 4], [1, 1, 2, 0]]),
        corpus_dataloader=types.SimpleNamespace(dataset=docs), idx=[f"d{i}" for i in range(6)],
        _row2ds=np.array([0, 1, 2, 4, 3, 5]))
    args = tconfig.DataArguments(train_n_passages=3, q_max_len=8)
    miner = DenseMiner(trainer, data["tokenizer"], args, headroom=2)
    samples = [{"query": [7, 8], "positives": [[12, 22]], "negatives": [["old"]]}
               for _ in range(3)]
    mined = miner.mine(samples, positive_docids=[{"d2"}, set(), {"d1"}])
    assert mined[0]["negatives"] == [[10, 20], [15, 25]]  # -1 skipped, own d2 excluded
    assert mined[1]["negatives"] == [[14, 24], [13, 23]]  # rows 3, 4 -> dataset rows 4, 3
    assert mined[2]["negatives"] == [[12, 22], [10, 20]]  # own d1 excluded twice
    by_tokens = miner.mine(samples)
    assert by_tokens[0]["negatives"] == [[10, 20], [15, 25]]  # own tokens [12, 22] excluded
    trainer.index = _Index([[-1, -1, 2, -1]])
    assert miner.mine(samples[:1])[0]["negatives"] == [["old"]]  # none but its own: kept
    trainer.index = None
    with pytest.raises(RuntimeError, match="index not built"):
        miner.mine(samples)
    trainer.index, trainer.corpus_dataloader = _Index([[0, 1, 2, 3]] * 3), None
    with pytest.raises(RuntimeError, match="corpus dataloader's dataset"):
        miner.mine(samples)


@pytest.mark.parametrize("index", ["fresh", "stale"])
def test_trainer_hook_matches_jax(data, index):
    """Two epochs with ``mine_per_train=1``: after each epoch the train set is the miner's
    output, equal in both packages, and epoch 2 trains on it (losses within 1e-5 rel +
    2e-6). 'fresh' mines from the index the evaluation just built; 'stale' has no
    evaluation, so the hook encodes the corpus itself."""
    jtrainer, ttrainer = _pair(data, f"hook-{index}", with_eval=index == "fresh")
    jtrainer.train()
    ttrainer.train()
    assert ttrainer._indexed_ep == 2
    got, want = ttrainer.train_loader.dataset, jtrainer.train_loader.dataset
    assert isinstance(got, list) and got == want and len(got) == 16
    assert got != data["train"]

    def losses(trainer):
        with open(os.path.join(trainer.training_args.output_dir, "train_log.jsonl")) as fh:
            return [r["loss"] for r in map(json.loads, fh) if "loss" in r]

    assert len(losses(ttrainer)) == 8
    np.testing.assert_allclose(losses(ttrainer), losses(jtrainer), rtol=1e-5, atol=2e-6)


# --- BM25 ---------------------------------------------------------------------------------------

def _bm25_corpus(rng, n_samples=40, vocab=200):
    return [{"query": [rng.randrange(vocab) for _ in range(6)],
             "positives": [[rng.randrange(vocab) for _ in range(rng.randrange(5, 20))]],
             "negatives": [[rng.randrange(vocab) for _ in range(rng.randrange(5, 20))]
                           for _ in range(3)]} for _ in range(n_samples)]


def test_native_bm25_matches_python():
    """The port's engine, built from its own ``native/bm25.cpp`` into ``_build/``, ranks
    as the Python retriever by score (atol 1e-4, ties in any order; as
    ``tests/test_bm25_native.py:33-52``), excludes a span, and ``search_batch`` equals
    ``search`` row by row."""
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR and os.path.exists(path)
    assert tnative.SOURCE.endswith(os.path.join("denseretrievaltoolkits_torch", "native",
                                                "bm25.cpp"))
    rng = random.Random(0)
    corpus = _bm25_corpus(rng)
    py, nat = tbm25.BM25Retriever(topK=5), tnative.NativeBM25Retriever(topK=5)
    assert py.load_passages(corpus) == nat.load_passages(corpus)
    queries = [[rng.randrange(200) for _ in range(6)] for _ in range(20)]
    for q in queries:
        def score(ids):
            return sorted((sum(py._score_term(w, d) for w in q
                               if d in py.doc_contained_word.get(w, ())) for d in ids),
                          reverse=True)
        np.testing.assert_allclose(score(nat.search(q, 10)), score(py.search(q, 10)), atol=1e-4)
    excl = nat.search(corpus[0]["positives"][0], 5, exclude=(0, 1))
    assert 0 not in excl
    batch = nat.search_batch(queries[:8], k=7)
    for q, row in zip(queries[:8], batch):
        want = [int(d) for d in row if d >= 0]
        assert nat.search(q, 7)[:len(want)] == want


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_bm25_negatives_match_jax(use_native, tmp_path):
    """The port's and the JAX package's ``BM25Negatives`` on the same rows: the same
    mined dataset, the same cache file name (content key) and bytes; a second call
    reads the cache."""
    corpus = _bm25_corpus(random.Random(3), n_samples=30)
    out = {}
    for side, mod in (("jax", jsam), ("port", tsam)):
        args = tconfig.DataArguments(train_n_passages=4, data_cache_dir=str(tmp_path / side))
        sampler = mod.BM25Negatives(args, vocab_size=200, seed=5, use_native=use_native)
        assert type(sampler.retriever).__name__ == ("NativeBM25Retriever" if use_native
                                                    else "BM25Retriever")
        mined = sampler.load_passages(corpus)
        files = glob.glob(str(tmp_path / side / "BM25data" / "bm25negatives.*"))
        assert len(files) == 1
        with open(files[0], "rb") as fh:
            out[side] = (mined, os.path.basename(files[0]), fh.read())
        assert mod.BM25Negatives(args, vocab_size=200, seed=5,
                                 use_native=use_native).load_passages(corpus) == mined
    assert out["port"] == out["jax"]
    mined = out["port"][0]
    for row, sample in zip(mined, corpus):
        assert len(row["negatives"]) == 3
        assert not {tuple(n) for n in row["negatives"]} & {tuple(p) for p in sample["positives"]}


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a failed build raises with the compiler's output."""
    bad = tmp_path / "bm25.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    tnative.load_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tsam.BM25Negatives(tconfig.DataArguments(train_n_passages=3), vocab_size=50)
    finally:
        tnative.load_lib.cache_clear()


def test_bm25_entry_point_matches_jax(data, tmp_path):
    """The ``run_BM25_negative`` twin against the root script on the same flags: the
    same BM25 cache file, per-step losses within rtol 1e-5, atol 2e-6, and the dev and
    test metric files with the same query counts. The root script trains over the 8
    virtual CPU devices of ``tests/conftest.py``; the port on one. Without a card the
    twin's default device raises before any data loads."""
    tok_dir = str(tmp_path / "tok")
    data["tokenizer"].save_pretrained(tok_dir)
    ckpt = str(tmp_path / "init")
    tbi.DRModel.build(tconfig.ModelArguments(), bert_config=tbert.BertConfig(**data["cfg"]),
                      seed=4, device="cpu").save(ckpt)
    common = ["--model_name_or_path", ckpt, "--tokenizer_name", tok_dir, "--dataset", "nq",
              "--data_dir", data["jdata"].data_dir, "--corpus_path", data["jdata"].corpus_path,
              "--train_n_passages", "2", "--q_max_len", "16", "--p_max_len", "24",
              "--train_batch_size", "8", "--eval_batch_size", "8", "--test_batch_size", "8",
              "--corpus_batch_size", "8", "--max_epochs", "1", "--eval_per_train", "1",
              "--save_per_train", "1", "--learning_rate", "1e-3", "--topk", "1,5",
              "--retrieve_num", "5", "--log_every", "1", "--seed", "3"]
    runs = {}
    for side, main in (("jax", jax_bm25_entry.main),
                       ("port", lambda argv: port_bm25_entry.main(argv, device="cpu"))):
        root = tmp_path / side
        main(common + ["--data_cache_dir", str(root / "hf"), "--output_dir", str(root / "out"),
                       "--cache_train_dir", str(root / "cache")])
        with open(root / "out" / "train_log.jsonl") as fh:
            losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        metrics = {}
        for path in sorted(glob.glob(str(root / "cache" / "*_metrics"))):
            with open(path) as fh:
                metrics[os.path.basename(path)] = json.load(fh)
        (cache,) = glob.glob(str(root / "hf" / "BM25data" / "bm25negatives.*"))
        with open(cache, "rb") as fh:
            runs[side] = losses, metrics, os.path.basename(cache), fh.read()
    (j_losses, j_metrics, j_name, j_cache), (t_losses, t_metrics, t_name, t_cache) = \
        runs["jax"], runs["port"]
    assert (t_name, t_cache) == (j_name, j_cache)
    assert len(t_losses) == len(j_losses) == 2
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=2e-6)
    assert sorted(t_metrics) == sorted(j_metrics) == ["-1.0_metrics", "1.0_metrics"]
    for name, m in t_metrics.items():
        assert m["query_num"] == j_metrics[name]["query_num"] == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            port_bm25_entry.main(common + ["--output_dir", str(tmp_path / "r")])
    with pytest.raises(ValueError, match="tp_size 2 must divide the world size 1"):
        port_bm25_entry.main(common + ["--tp_size", "2"], device="cpu")

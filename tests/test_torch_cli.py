"""The port's CLIs without ``transformers`` or ``datasets``, ``run_toolkits`` and
``data/simple_preprocess``, on the CPU.

The card's machine has neither HF package. With both made unimportable
(``sys.modules`` entries set to None), ``run_toolkits.main`` drives every
stage on a BERT tokenizer directory and local JSON-Lines data: ``train_random``
(one epoch with evaluation), ``encode`` (passages and queries), ``retrieve``
(its ranking equal to the trainer's), ``nq_eval`` (its top-k accuracies equal to
the trainer's Recall@k on the same ranking), ``train_bm25`` (native BM25) and
``rerank`` over the ``train_random`` dump. ``run_toolkits`` keeps the JAX
script's usage text and unknown-stage exit (``tests/test_utils_misc.py:83``)
and sends each stage to the port's module. ``simple_preprocess`` gives the JAX
module's rows.
"""

import csv
import json
import os
import random
import sys

import numpy as np
import pytest

import run_toolkits as jax_toolkits
from denseretrievaltoolkits_torch import run_toolkits
from denseretrievaltoolkits_torch.data import simple_preprocess as tsp
from denseretrievaltoolkits_torch.evaluator.convert import retrieval_jsonl_to_nq_json
from denseretrievaltoolkits_torch.evaluator.retrieval import pickle_load
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_tpu.data import simple_preprocess as jsp

from helpers import WORDS, make_exactmatch_dataset, make_tokenizer

N_EVAL = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    tokenizer = make_tokenizer(tmp)
    tok_dir = str(tmp / "tok")
    tokenizer.save_pretrained(tok_dir)
    data_dir, corpus_path, _, corpus = make_exactmatch_dataset(
        tmp, random.Random(5), n_train=16, n_eval=N_EVAL, n_corpus=48, n_neg=3)
    model_dir = str(tmp / "arch")
    tbert.save_config(tbert.BertConfig(vocab_size=tokenizer.vocab_size, hidden_size=32,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       intermediate_size=64, max_position_embeddings=48),
                      model_dir)
    return dict(tmp=tmp, tok_dir=tok_dir, data_dir=data_dir, corpus_path=corpus_path,
                corpus=corpus, model_dir=model_dir)


def test_pipeline_without_hf_packages(setup, monkeypatch):
    s = setup
    for name in ("transformers", "datasets"):
        monkeypatch.setitem(sys.modules, name, None)
    work = s["tmp"] / "run"
    cache, out = str(work / "cache"), str(work / "out")
    common = ["--tokenizer_name", s["tok_dir"], "--dataset", "nq", "--data_dir", s["data_dir"],
              "--data_cache_dir", str(work / "data_cache"), "--q_max_len", "16",
              "--p_max_len", "24", "--corpus_batch_size", "8", "--seed", "3"]
    run = lambda argv: run_toolkits.main(argv, device="cpu")  # noqa: E731
    run(["train_random"] + common + [
        "--model_name_or_path", s["model_dir"], "--corpus_path", s["corpus_path"],
        "--train_n_passages", "2", "--train_batch_size", "8", "--eval_batch_size", "8",
        "--test_batch_size", "8", "--max_epochs", "1", "--eval_per_train", "1",
        "--save_per_train", "1", "--learning_rate", "1e-3", "--topk", "1,5,10",
        "--retrieve_num", "10", "--log_every", "1", "--output_dir", out,
        "--cache_train_dir", cache])
    with open(os.path.join(cache, "-1.0_metrics")) as fh:
        metrics = json.load(fh)
    assert metrics["query_num"] == N_EVAL and os.path.exists(os.path.join(cache, "1.0_metrics"))

    enc = common + ["--model_name_or_path", os.path.join(cache, "result1")]
    q_pkl, p_pkl = str(work / "q.pkl"), str(work / "p.pkl")
    run(["encode"] + enc + ["--encode_in_path", s["corpus_path"], "--encodedp_save_path", p_pkl])
    run(["encode"] + enc + ["--encode_in_path", os.path.join(s["data_dir"], "test.jsonl"),
                            "--encode_is_qry", "--encodedq_save_path", q_pkl])
    p_reps, p_ids = pickle_load(p_pkl)
    q_reps, q_ids = pickle_load(q_pkl)
    assert p_reps.shape == (len(s["corpus"]), 32) and p_ids == [r["docid"] for r in s["corpus"]]
    assert q_reps.shape == (N_EVAL, 32) and np.isfinite(q_reps).all()

    ranking = str(work / "ranking.tsv")
    run(["retrieve", "--query_reps", q_pkl, "--passage_reps", p_pkl, "--depth", "10",
         "--save_ranking_to", ranking, "--save_text"])
    cli = {}
    with open(ranking) as fh:
        for line in fh:
            qid, did, _ = line.split("\t")
            cli.setdefault(qid, []).append(did)
    dumped = {}
    with open(os.path.join(cache, "retrieve", "-1.0.json")) as fh:
        for row in map(json.loads, fh):
            dumped.setdefault(row["query_id"], []).append(row["doc_id"])
    assert cli == dumped

    nq_json = str(work / "nq.json")
    retrieval_jsonl_to_nq_json(os.path.join(cache, "retrieve", "-1.0.json"), nq_json)
    acc = run(["nq_eval", "--retrieval", nq_json, "--topk", "1", "5", "10"])
    assert acc == {k: metrics[f"Recall@{k}"] for k in (1, 5, 10)}

    bm25 = work / "bm25"
    run(["train_bm25"] + common + [
        "--model_name_or_path", s["model_dir"], "--train_n_passages", "3",
        "--train_batch_size", "8", "--max_epochs", "1", "--save_per_train", "1",
        "--learning_rate", "1e-3", "--log_every", "1", "--output_dir", str(bm25 / "out"),
        "--cache_train_dir", str(bm25 / "cache")])
    with open(bm25 / "out" / "train_log.jsonl") as fh:
        losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()

    rr_cache = work / "rr_cache"
    (rr_cache / "retrieve").mkdir(parents=True)
    (rr_cache / "retrieve" / "-1.0.json").write_bytes(
        open(os.path.join(cache, "retrieve", "-1.0.json"), "rb").read())
    rr = run(["rerank"] + common + [
        "--model_name_or_path", s["model_dir"], "--train_n_passages", "3",
        "--train_batch_size", "8", "--eval_batch_size", "16", "--max_epochs", "1",
        "--save_per_train", "1", "--learning_rate", "1e-3", "--loss_fn", "mr",
        "--log_every", "0", "--output_dir", str(work / "rr_out"),
        "--cache_train_dir", str(rr_cache)])
    assert rr["query_num"] == N_EVAL
    assert json.loads((rr_cache / "3.0_RR_metrics").read_text())["query_num"] == N_EVAL


def test_run_toolkits_usage_and_unknown_stage():
    """As ``tests/test_utils_misc.py:83`` holds the JAX script: no stage and an unknown
    one exit with the usage, which is the JAX script's text."""
    assert run_toolkits.__doc__ == jax_toolkits.__doc__
    with pytest.raises(SystemExit) as exc:
        run_toolkits.main([])
    assert exc.value.code == run_toolkits.__doc__
    with pytest.raises(SystemExit, match="unknown stage 'bogus_stage'"):
        run_toolkits.main(["bogus_stage"])
    old = sys.argv
    try:
        sys.argv = ["run_toolkits.py"]
        with pytest.raises(SystemExit):
            run_toolkits.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("stage,module,attr", [
    ("train_random", "denseretrievaltoolkits_torch.run_random_sampling", "main"),
    ("train_bm25", "denseretrievaltoolkits_torch.run_BM25_negative", "main"),
    ("rerank", "denseretrievaltoolkits_torch.run_reranker", "main"),
    ("encode", "denseretrievaltoolkits_torch.run_encode", "main"),
    ("retrieve", "denseretrievaltoolkits_torch.evaluator.retrieval", "main"),
    ("nq_eval", "denseretrievaltoolkits_torch.evaluator.nq_eval", "main")])
def test_each_stage_reaches_the_port(monkeypatch, stage, module, attr):
    import importlib

    mod = importlib.import_module(module)
    calls = []
    monkeypatch.setattr(mod, attr, lambda *a, **k: calls.append((a, k)) or stage)
    argv = ["--x", "1"] + (["--eval_only"] if stage == "rerank" else [])
    assert run_toolkits.main([stage] + argv, device="cpu") == stage
    (args, kw), = calls
    assert args[0] == ["--x", "1"]
    if stage == "rerank":
        assert kw == {"eval_only": True, "device": "cpu"}
    elif stage != "nq_eval":
        assert kw == {"device": "cpu"}


def test_simple_preprocess_matches_jax(tmp_path):
    """``SimpleTrainPreProcessor`` (queries, the tsv collection, templates) and
    ``SimpleCollectionPreProcessor`` give the JAX module's json rows; the template
    helpers are the same functions' copies."""
    rng = random.Random(9)
    tok = make_tokenizer(tmp_path)
    queries, collection = tmp_path / "queries.tsv", tmp_path / "collection.tsv"
    with open(queries, "w") as fh:
        for i in range(6):
            fh.write(f"q{i}\t{' '.join(rng.choice(WORDS) for _ in range(5))}\n")
    with open(collection, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t")
        for i in range(10):
            title = "" if i % 4 == 0 else " ".join(rng.choice(WORDS) for _ in range(2))
            w.writerow([str(i), title, " ".join(rng.choice(WORDS) for _ in range(12))])
    triples = [(f"q{i}", [str(i)], [str((i + 3) % 10), str((i + 5) % 10)]) for i in range(6)]
    for kw in ({}, {"doc_template": "<title> | <text>", "query_template": "Q: <text>",
               "allow_not_found": True}):
        j = jsp.SimpleTrainPreProcessor(str(queries), str(collection), tok, doc_max_len=12,
                                        query_max_len=6, **kw)
        t = tsp.SimpleTrainPreProcessor(str(queries), str(collection), tok, doc_max_len=12,
                                        query_max_len=6, **kw)
        assert [t.process_one(x) for x in triples] == [j.process_one(x) for x in triples]
    lines = open(collection).read().splitlines()
    jc, tc = jsp.SimpleCollectionPreProcessor(tok, max_length=9), \
        tsp.SimpleCollectionPreProcessor(tok, max_length=9)
    assert [tc.process_line(x) for x in lines] == [jc.process_line(x) for x in lines]
    data = {"a": {"b": 3}, "c": "x"}
    assert tsp.find_all_markers("<a.b> and <c>") == jsp.find_all_markers("<a.b> and <c>")
    assert tsp.fill_template("<a.b>-<c>", data) == jsp.fill_template("<a.b>-<c>", data) == "3-x"
    with pytest.raises(ValueError, match="marker"):
        tsp.fill_template("<z>", data)

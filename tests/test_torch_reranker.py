"""The port's cross-encoder reranker against the JAX package's, on the CPU.

``RRModel`` (backbones ``bert``, ``t5``, ``t5_full``; losses mr, smr, bce, ce),
``RRTrainer`` (its steps and ``evaluate``: the rerank dump and the metrics) and the
``run_reranker`` twin against the root script. Weights are made with numpy from a
seed and carried across by ``models/convert.py``; tiny widths. fp32 scores within
rtol 1e-5, atol 2e-5 (sums in another order); losses and gradients and the
trajectories take ``tests/test_torch_train.py``'s tolerances.
"""

import dataclasses
import glob
import json
import os
import random
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import run_reranker as jax_entry
from denseretrievaltoolkits_tpu.config import (DataArguments, ModelArguments,
                                               RRTrainingArguments)
from denseretrievaltoolkits_tpu.data import datasets as jds
from denseretrievaltoolkits_tpu.data import loaders as jload
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import reranker as jrr
from denseretrievaltoolkits_tpu.models import t5 as jt5
from denseretrievaltoolkits_tpu.train import trainer as jtrainer
from denseretrievaltoolkits_torch import run_reranker as port_entry
from denseretrievaltoolkits_torch.data import datasets as tds
from denseretrievaltoolkits_torch.data import loaders as tload
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import reranker as trr
from denseretrievaltoolkits_torch.models import t5 as tt5
from denseretrievaltoolkits_torch.models.convert import params_to_jax
from denseretrievaltoolkits_torch.train.trainer import RRTrainer

from helpers import make_exactmatch_dataset, make_tokenizer

BERT = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=48)
T5 = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
          relative_attention_num_buckets=8, relative_attention_max_distance=20,
          is_gated_act=True)
FP32 = dict(rtol=1e-5, atol=2e-5)
TOKENS = {"yes": 17, "no": 5}  # the stub tokenizer's ids of pos_token / neg_token


class _Tok:
    """``encode(token, add_special_tokens=False)`` of a tokenizer with two known words."""

    def encode(self, text, add_special_tokens=True):
        return [TOKENS[text], 1]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pairs(n, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 96, (n, S)).astype(np.int32)
    lens = rng.integers(2, S + 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return {"input_ids": np.where(mask == 1, ids, 0).astype(np.int32), "attention_mask": mask}


def _arch(tmp, backbone):
    path = str(tmp / f"arch-{backbone}")
    if backbone == "bert":
        tbert.save_config(tbert.BertConfig(**BERT), path)
    else:
        tt5.save_config(tt5.T5Config(**T5), path)
    return path


def _port(tmp, backbone, loss_fn="mr", pooling="first", seed=3, **kw):
    """A port RRModel from an architecture-only dir (seeded random init)."""
    margs = ModelArguments(model_name_or_path=_arch(tmp, backbone), pooling=pooling,
                           encoder_only=backbone == "t5", pos_token="yes", neg_token="no", **kw)
    targs = RRTrainingArguments(output_dir=str(tmp / "o"), cache_train_dir=str(tmp / "c"),
                                loss_fn=loss_fn, margin=0.7)
    return trr.RRModel.build(margs, train_args=targs, tokenizer=_Tok(), device="cpu", seed=seed)


def _jax_side(port):
    s = port.spec
    cfg = s.bert_config
    jcfg = (jt5.T5Config(**dataclasses.asdict(cfg)) if s.backbone != "bert"
            else jbert.BertConfig(**dataclasses.asdict(cfg)))
    jmodel = jrr.RRModel(jrr.RRModelSpec(
        bert_config=jcfg, backbone=s.backbone, pooling=s.pooling, loss_fn=s.loss_fn,
        margin=s.margin, pos_token_id=s.pos_token_id, neg_token_id=s.neg_token_id))
    params = {"lm": params_to_jax(port.lm.state_dict())}
    if port.head is not None:
        params["head"] = {"kernel": port.head.kernel.detach().numpy().copy()}
    return jmodel, jax.tree.map(jnp.asarray, params)


def _grads(module):
    return {k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in module.named_parameters()}


# ce is the 2-way loss of t5_full's [neg, pos] logits; a [B, 1] head has no second class
CASES = [("bert", "mr", 6), ("bert", "smr", 3), ("bert", "bce", 6), ("t5", "mr", 3),
         ("t5", "smr", 6), ("t5", "bce", 3), ("t5_full", "ce", 6), ("t5_full", "mr", 3)]


@pytest.mark.parametrize("backbone,loss_fn,n_neg", CASES,
                         ids=[f"{b}-{loss}-neg{n}" for b, loss, n in CASES])
def test_forward_matches_jax(tmp_path, backbone, loss_fn, n_neg):
    """``encode`` ([B, 1] through the head; [B, 2] [neg, pos] logits for ``t5_full``) and
    ``forward``: scores within fp32 tolerance, the loss within 1e-5 relative and every
    gradient within atol 5e-5, rtol 1e-4 of ``jax.value_and_grad``; 3 positives over 6
    negatives broadcast each positive twice. ``t5_full`` trains with ce whatever is
    asked."""
    port = _port(tmp_path, backbone, loss_fn, pooling="mean" if backbone == "t5" else "first")
    assert port.spec.loss_fn == ("ce" if backbone == "t5_full" else loss_fn)
    pos, neg = _pairs(3, 14, 1), _pairs(n_neg, 14, 2)
    jmodel, jparams = _jax_side(port)
    jpos, jneg = jax.tree.map(jnp.asarray, pos), jax.tree.map(jnp.asarray, neg)
    scores = port.score(neg)
    assert scores.shape == (n_neg, 2 if backbone == "t5_full" else 1)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jmodel.encode(jparams, jneg)), **FP32)
    ref, jgrads = jax.value_and_grad(
        lambda prm: jmodel.forward(prm, jpos, jneg)["loss"])(jparams)
    out = port(pos, neg)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(ref), rtol=1e-5)
    got = {"lm": params_to_jax(_grads(port.lm))}
    if port.head is not None:
        got["head"] = {"kernel": port.head.kernel.grad.numpy()}
    want, got = _flat(jgrads), _flat(got)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=5e-5, err_msg=k)
    only_pos = port(pos)
    assert set(only_pos) == {"pos_pair_scores"}
    assert "loss" not in port(pos, _pairs(4, 14, 3))  # no broadcast: no loss, as JAX


@pytest.mark.parametrize("backbone", ["bert", "t5", "t5_full"])
def test_save_and_build_across_packages(tmp_path, backbone):
    """Port -> JAX: the port's ``save`` is built by the JAX ``RRModel.build`` (token ids
    from the tokenizer) and scores the same pairs; JAX -> port: a JAX ``save`` of its
    own init is built by the port's."""
    port = _port(tmp_path, backbone, pooling="mean")
    port.save(str(tmp_path / "port"))
    names = set(os.listdir(tmp_path / "port"))
    assert {"weights.npz", "openmatch_config.json"} <= names
    assert ("linear.npz" in names) == (backbone != "t5_full")
    margs = ModelArguments(model_name_or_path=str(tmp_path / "port"))
    jmodel, jparams = jrr.RRModel.build(margs, tokenizer=_Tok())
    assert jmodel.spec.backbone == backbone
    pairs = _pairs(5, 12, 4)
    np.testing.assert_allclose(port.score(pairs).numpy(),
                               np.asarray(jmodel.encode(jparams, pairs)), **FP32)
    jmodel.save(jparams, str(tmp_path / "jax"))
    back = trr.RRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "jax")),
                             tokenizer=_Tok(), device="cpu")
    assert back.spec.backbone == backbone and back.spec.pos_token_id == TOKENS["yes"]
    torch.testing.assert_close(back.score(pairs), port.score(pairs), rtol=0, atol=0)


def test_build_sources_and_refusals(tmp_path):
    """An HF BERT directory builds a ``bert`` reranker with the JAX build's scores (the
    head from the seed on both sides is carried across); hub ids refuse, as
    ``DRModel.build``; an unknown loss raises; without a card the default device
    raises."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    BertModel(BertConfig(**BERT)).save_pretrained(str(tmp_path / "hf-bert"))
    port = trr.RRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "hf-bert")),
                             device="cpu", seed=2)
    assert port.spec.backbone == "bert" and port.head.kernel.shape == (32, 1)
    jmodel, jparams = jrr.RRModel.build(ModelArguments(model_name_or_path=str(tmp_path /
                                                                                "hf-bert")))
    jparams = {**jparams, "head": {"kernel": jnp.asarray(port.head.kernel.detach().numpy())}}
    pairs = _pairs(4, 10, 5)
    np.testing.assert_allclose(port.score(pairs).numpy(),
                               np.asarray(jmodel.encode(jparams, pairs)), **FP32)
    with pytest.raises(NotImplementedError, match="needs a download"):
        trr.RRModel.build(ModelArguments(model_name_or_path="google-t5/t5-base"), device="cpu")
    with pytest.raises(ValueError, match="loss"):
        trr.RRModelSpec(bert_config=tbert.BertConfig(**BERT), loss_fn="hinge")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            trr.RRModel.build(ModelArguments(model_name_or_path=_arch(tmp_path, "bert")))


# --- RRTrainer ------------------------------------------------------------------------------------

def _rr_args(root, **kw):
    base = dict(output_dir=str(root / "out"), cache_train_dir=str(root / "cache"),
                train_batch_size=4, eval_batch_size=4, learning_rate=1e-2, optimizer="sgd",
                topk="1,3,5", retrieve_num=5, log_every=0, save_per_train=10)
    base.update(kw)
    return RRTrainingArguments(**base)


@pytest.mark.parametrize("backbone,loss_fn", [("bert", "mr"), ("t5", "bce"), ("t5_full", "ce")])
def test_rrtrainer_trajectory_matches_jax(tmp_path, backbone, loss_fn):
    """4 steps of ``train_step`` on (pos_pairs, neg_pairs) batches (4 positives, 8
    negatives) from the same weights. SGD: losses within rtol 1e-5, atol 2e-6 and the
    final tower parameters within atol 5e-5. AdamW: the same losses; its parameters are
    not compared, since Adam scales each gradient by its running RMS and so lifts fp32
    noise to a share of lr where a gradient is 0 in exact arithmetic (the last layer's
    LN bias under a pairwise loss, whose term cancels between pos and neg: read 4e-8,
    moving it by up to 0.005 either way in 4 steps; ROADMAP queue 3, findings)."""
    batches = [(_pairs(4, 12, 10 + i), _pairs(8, 12, 20 + i)) for i in range(4)]
    for optimizer, lr in (("sgd", 1e-2), ("adamw", 3e-3)):
        port = _port(tmp_path, backbone, loss_fn)
        jmodel, jparams = _jax_side(port)
        kw = dict(loss_fn=loss_fn, optimizer=optimizer, learning_rate=lr)
        trainer = RRTrainer(_rr_args(tmp_path / f"port-{optimizer}", **kw), port)
        jt = jtrainer.RRTrainer(_rr_args(tmp_path / f"jax-{optimizer}", **kw), jmodel, jparams)
        ours = [float(trainer.train_step(b)) for b in batches]
        ref = [float(jt.train_step(b)) for b in batches]
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-6, err_msg=optimizer)
        assert trainer.step == 4 and ours[0] != ours[-1]
        if optimizer == "sgd":
            want = _flat(jt.state["params"]["lm"])
            got = _flat(params_to_jax(port.lm.state_dict()))
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-5, err_msg=k)


def _write_dump(retrieve_dir, splits, corpus_rows, k=5, seed=0):
    """A dense retriever's dump (``Trainer.evaluate``'s row schema) over the dev split:
    each query's positive and k - 1 random corpus docs."""
    rng = random.Random(seed)
    os.makedirs(retrieve_dir, exist_ok=True)
    with open(os.path.join(retrieve_dir, "2.0.json"), "w") as fh:
        for row in splits["dev"]:
            pos = row["positive_passages"][0]["docid"]
            docids = [pos] + [f"d{rng.randrange(len(corpus_rows))}" for _ in range(k - 1)]
            for rank, d in enumerate(docids):
                doc = corpus_rows[int(d[1:])]
                fh.write(json.dumps({"doc_id": d, "query_id": row["query_id"],
                                     "query": row["query"],
                                     "document": doc["title"] + " " + doc["text"],
                                     "answers": row["answers"], "score": float(k - rank)}) + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rr")
    tokenizer = make_tokenizer(tmp)
    data_dir, corpus_path, splits, corpus_rows = make_exactmatch_dataset(
        tmp, random.Random(0), n_train=16, n_eval=8, n_corpus=32, n_neg=4)
    return tmp, tokenizer, data_dir, corpus_path, splits, corpus_rows


def _read_rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_rrtrainer_evaluate_matches_jax(data, tmp_path):
    """``evaluate`` over the dense retriever's dump (``tests/test_trainer_e2e.py``'s
    handoff: ``RRDataset`` + ``RerankerDataloader``): the ``3.0.json`` rows equal JAX's
    (qid, did, match, document; scores within fp32 tolerance) and the ``3.0_RR_metrics``
    too, ``query_num`` 8."""
    _, tokenizer, data_dir, corpus_path, splits, corpus_rows = data
    dargs = DataArguments(data_dir=data_dir, corpus_path=corpus_path, q_max_len=16,
                          p_max_len=24, data_cache_dir=str(tmp_path / "hf"))
    cfg = tbert.BertConfig(**{**BERT, "vocab_size": tokenizer.vocab_size})
    port = trr.RRModel.build(ModelArguments(), bert_config=cfg, device="cpu", seed=5)
    jmodel, jparams = _jax_side(port)
    metrics = {}
    for side, rr_trainer, ds_mod, load_mod in (
            ("port", lambda a: RRTrainer(a, port), tds, tload),
            ("jax", lambda a: jtrainer.RRTrainer(a, jmodel, jparams), jds, jload)):
        args = _rr_args(tmp_path / side)
        _write_dump(args.retrieve_dir, splits, corpus_rows)
        eval_dl = load_mod.RerankerDataloader(
            dargs, ds_mod.RRDataset(dargs, args, tokenizer), tokenizer,
            batch_size=args.eval_batch_size).get_eval_dataloader()
        metrics[side] = rr_trainer(args).evaluate(eval_dl, 3)
        with open(os.path.join(args.cache_train_dir, "3.0_RR_metrics")) as fh:
            assert json.load(fh) == metrics[side]
    rows = {s: _read_rows(tmp_path / s / "cache" / "rr" / "3.0.json") for s in metrics}
    assert len(rows["port"]) == len(rows["jax"]) == 40
    for a, b in zip(rows["port"], rows["jax"]):
        assert {k: a[k] for k in ("qid", "did", "match", "document")} == \
            {k: b[k] for k in ("qid", "did", "match", "document")}
        np.testing.assert_allclose(a["score"], b["score"], **FP32)
    assert sum(r["match"] for r in rows["port"]) >= 8
    assert metrics["port"] == pytest.approx(metrics["jax"], rel=1e-12)
    assert metrics["port"]["query_num"] == 8


# --- the run_reranker twin -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def entry(data):
    """One saved BERT reranker dir, one tokenizer dir, the ExactMatch data, and each
    side's cache dir holding the same retrieval dump."""
    tmp, tokenizer, data_dir, corpus_path, splits, corpus_rows = data
    tok_dir = str(tmp / "tok")
    tokenizer.save_pretrained(tok_dir)
    cfg = tbert.BertConfig(**{**BERT, "vocab_size": tokenizer.vocab_size})
    ckpt = str(tmp / "rr-init")
    trr.RRModel.build(ModelArguments(), bert_config=cfg, device="cpu", seed=4).save(ckpt)
    _write_dump(str(tmp / "dump"), splits, corpus_rows)
    common = ["--model_name_or_path", ckpt, "--tokenizer_name", tok_dir, "--dataset", "nq",
              "--data_dir", data_dir, "--corpus_path", corpus_path,
              "--data_cache_dir", str(tmp / "hf"), "--train_n_passages", "2",
              "--q_max_len", "16", "--p_max_len", "24", "--train_batch_size", "8",
              "--eval_batch_size", "8", "--max_epochs", "1", "--save_per_train", "1",
              "--optimizer", "sgd", "--learning_rate", "1e-2", "--topk", "1,3,5",
              "--loss_fn", "smr",
              "--log_every", "0", "--seed", "3"]
    return tmp, common


def _run_entry(tmp, common, label, monkeypatch, flags=(), eval_only=False):
    """Run both entry points; each side's per-step losses, rerank rows and metrics."""
    out = {}
    for side, main, cls in (
            ("jax", lambda argv: jax_entry.main(argv, eval_only=eval_only), jtrainer.RRTrainer),
            ("port", lambda argv: port_entry.main(argv, eval_only=eval_only, device="cpu"),
             RRTrainer)):
        root = tmp / f"{label}-{side}"
        shutil.copytree(tmp / "dump", root / "cache" / "retrieve")
        losses = []
        step = cls.train_step

        def recording(self, batch, step=step, losses=losses):
            loss = step(self, batch)
            losses.append(float(loss))
            return loss

        monkeypatch.setattr(cls, "train_step", recording)
        main(common + list(flags) + ["--output_dir", str(root / "out"),
                                     "--cache_train_dir", str(root / "cache")])
        monkeypatch.setattr(cls, "train_step", step)
        with open(root / "cache" / "3.0_RR_metrics") as fh:
            metrics = json.load(fh)
        out[side] = losses, _read_rows(root / "cache" / "rr" / "3.0.json"), metrics, root
    return out


@pytest.mark.parametrize("eval_only", [False, True], ids=["train-then-evaluate", "eval-only"])
def test_entry_point_matches_jax(entry, monkeypatch, eval_only):
    """The root script (over the 8 virtual CPU devices of ``tests/conftest.py``: its dp
    mesh) and the twin (one CPU device) from one saved reranker dir: the same per-step
    losses (rtol 1e-5, atol 2e-6; none with ``--eval_only``), the same ``3.0.json`` rows
    (scores within fp32 tolerance) and ``3.0_RR_metrics``; a deploy-format save per
    epoch. SGD, so the rows after training compare the weights, not Adam's lift of fp32
    noise (``test_rrtrainer_trajectory_matches_jax``)."""
    tmp, common = entry
    runs = _run_entry(tmp, common, "eval" if eval_only else "train", monkeypatch,
                      eval_only=eval_only)
    (j_losses, j_rows, j_metrics, _), (t_losses, t_rows, t_metrics, root) = \
        runs["jax"], runs["port"]
    assert len(t_losses) == len(j_losses) == (0 if eval_only else 2)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=2e-6)
    assert len(t_rows) == len(j_rows) == 40
    for a, b in zip(t_rows, j_rows):
        assert {k: a[k] for k in ("qid", "did", "match", "document")} == \
            {k: b[k] for k in ("qid", "did", "match", "document")}
        np.testing.assert_allclose(a["score"], b["score"], **FP32)
    assert t_metrics.keys() == j_metrics.keys() and t_metrics["query_num"] == 8
    for key in t_metrics:
        assert t_metrics[key] == pytest.approx(j_metrics[key], rel=1e-12), key
    assert bool(glob.glob(str(root / "cache" / "result1"))) == (not eval_only)


def test_entry_point_refuses_tensor_parallel(entry):
    """``--tp_size 2`` in one process raises when the mesh is made, before anything loads
    (two ranks take it: tests/test_torch_tensor_parallel.py); without a card the
    default device raises."""
    tmp, common = entry
    argv = common + ["--output_dir", str(tmp / "r" / "out"),
                     "--cache_train_dir", str(tmp / "r" / "cache")]
    with pytest.raises(ValueError, match="tp_size 2 must divide the world size 1"):
        port_entry.main(argv + ["--tp_size", "2"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            port_entry.main(argv)

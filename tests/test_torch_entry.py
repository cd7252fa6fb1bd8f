"""The port's ``run_random_sampling`` against the JAX package's, on the CPU.

One tiny ExactMatch dataset (``helpers.make_exactmatch_dataset``), one local
tokenizer (``helpers.make_tokenizer``), one seed and one model dir in the
deploy format, which both packages load. Each entry point trains one epoch
(2 steps of 8 queries x 2 passages) from the dir, with and without
``--grad_cache``, evaluates on dev and test, and writes its train log and
metric files. The JAX one trains over the 8 virtual CPU devices of
``tests/conftest.py`` (its dp mesh); the port on one CPU device.
"""

import glob
import json
import os
import random
import re

import numpy as np
import pytest
import torch

import run_random_sampling as jax_entry
from denseretrievaltoolkits_torch import run_random_sampling as port_entry
from denseretrievaltoolkits_torch.config import ModelArguments
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi

from helpers import make_exactmatch_dataset, make_tokenizer


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    tokenizer = make_tokenizer(tmp)
    tok_dir = str(tmp / "tok")
    tokenizer.save_pretrained(tok_dir)
    data_dir, corpus_path, _, _ = make_exactmatch_dataset(tmp, random.Random(0), n_train=16,
                                                          n_eval=8, n_corpus=48, n_neg=3)
    config = tbert.BertConfig(vocab_size=tokenizer.vocab_size, hidden_size=32,
                              num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                              max_position_embeddings=48)
    ckpt = str(tmp / "init")
    tbi.DRModel.build(ModelArguments(), bert_config=config, seed=4, device="cpu").save(ckpt)
    common = ["--model_name_or_path", ckpt, "--tokenizer_name", tok_dir, "--dataset", "nq",
              "--data_dir", data_dir, "--corpus_path", corpus_path,
              "--data_cache_dir", str(tmp / "hf"), "--train_n_passages", "2",
              "--q_max_len", "16", "--p_max_len", "24", "--train_batch_size", "8",
              "--eval_batch_size", "8", "--test_batch_size", "8", "--corpus_batch_size", "8",
              "--max_epochs", "1", "--eval_per_train", "1", "--save_per_train", "1",
              "--learning_rate", "1e-3", "--topk", "1,5", "--retrieve_num", "5",
              "--log_every", "1", "--seed", "3"]
    return tmp, common


def _run(tmp, common, label, grad_cache):
    extra = ["--grad_cache", "--gc_q_chunk_size", "4", "--gc_p_chunk_size", "8"] \
        if grad_cache else []
    out = {}
    for side, main in (("jax", jax_entry.main), ("port", lambda argv: port_entry.main(
            argv, device="cpu"))):
        root = tmp / f"{label}-{side}"
        main(common + extra + ["--output_dir", str(root / "out"),
                               "--cache_train_dir", str(root / "cache")])
        with open(root / "out" / "train_log.jsonl") as fh:
            losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        metrics = {}
        for path in sorted(glob.glob(str(root / "cache" / "*_metrics"))):
            with open(path) as fh:
                metrics[os.path.basename(path)] = json.load(fh)
        out[side] = losses, metrics
    return out


@pytest.mark.parametrize("grad_cache", [False, True], ids=["full-batch", "grad-cache"])
def test_entry_point_matches_jax(setup, grad_cache):
    """Per-step losses within rtol 1e-5, atol 2e-6 (the trainer trajectory's
    tolerance); both write the dev (epoch 1) and test (-1) metric files, with
    the same query counts."""
    tmp, common = setup
    runs = _run(tmp, common, "gc" if grad_cache else "full", grad_cache)
    (j_losses, j_metrics), (t_losses, t_metrics) = runs["jax"], runs["port"]
    assert len(t_losses) == len(j_losses) == 2
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=2e-6)
    assert sorted(t_metrics) == sorted(j_metrics) == ["-1.0_metrics", "1.0_metrics"]
    for name, m in t_metrics.items():
        assert m["query_num"] == j_metrics[name]["query_num"] == 8
        assert m.keys() == j_metrics[name].keys()


@pytest.mark.parametrize("flags,item", [(["--mine_per_train", "1"], "Mining and BM25"),
                                         (["--tp_size", "2"], "must divide the world size 1")],
                         ids=["mining", "tensor-parallel"])
def test_entry_point_refuses_later_slices(setup, flags, item):
    """A ``--tp_size`` the world does not hold (2 in one process) raises when the mesh
    is made, before anything loads; tests/test_torch_parallel.py runs the entry point
    at ``--tp_size 2`` over two ranks. Hard-negative
    mining is ported: with ``--mine_per_train 1`` over 2 epochs both entry points
    attach a DenseMiner, and epoch 2 trains on the mined rows with the same losses
    (rtol 1e-5, atol 2e-6). Without a card, the default device raises before any data
    loads."""
    tmp, common = setup
    if item == "Mining and BM25":
        two = [a if a != "1" or common[i - 1] != "--max_epochs" else "2"
               for i, a in enumerate(common)]
        out = {}
        for side, main in (("jax", jax_entry.main),
                           ("port", lambda argv: port_entry.main(argv, device="cpu"))):
            root = tmp / f"mine-{side}"
            main(two + flags + ["--output_dir", str(root / "out"),
                                "--cache_train_dir", str(root / "cache")])
            with open(root / "out" / "train_log.jsonl") as fh:
                out[side] = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        assert len(out["port"]) == len(out["jax"]) == 4
        np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5, atol=2e-6)
        return
    argv = common + ["--output_dir", str(tmp / "r" / "out"),
                     "--cache_train_dir", str(tmp / "r" / "cache")]
    with pytest.raises(ValueError, match=re.escape(item)):
        port_entry.main(argv + flags, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            port_entry.main(argv)

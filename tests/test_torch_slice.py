"""The serving slice end to end on both packages, on the CPU.

JAX: encode -> FlatIPIndex.search -> get_metrics. Port: encode_batches ->
port FlatIPIndex -> get_metrics. Same checkpoint, same tokenised batches
(made with numpy from a seed). Checks equal ids and metrics, index files that
interchange both ways, and the offline retrieval CLI writing the same
ranking."""

import glob
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.config import ModelArguments
from denseretrievaltoolkits_tpu.data.collators import pad_batch
from denseretrievaltoolkits_tpu.data.loaders import pad_to_batch
from denseretrievaltoolkits_tpu.evaluator import retrieval as jret
from denseretrievaltoolkits_tpu.evaluator.metrics import get_metrics
from denseretrievaltoolkits_tpu.index import flat as jflat
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_torch.evaluator import retrieval as tret
from denseretrievaltoolkits_torch.index import flat as tflat
from denseretrievaltoolkits_torch.models.biencoder import DRModelForInference
from denseretrievaltoolkits_torch.run_encode import encode_batches

CFG = jbert.BertConfig(vocab_size=211, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128, max_position_embeddings=64)
BS = 32


def _batches(n, max_len, seed, prefix):
    """Lognormal lengths, padded with pad_batch: [(ids, batch), ...]."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(np.log(max_len / 3), 0.6, n).astype(int), 1, max_len)
    seqs = [rng.integers(1, CFG.vocab_size, L).tolist() for L in lens]
    return [([f"{prefix}{i}" for i in range(s, min(s + BS, n))],
             pad_batch(seqs[s:s + BS], max_len, 0)) for s in range(0, n, BS)]


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    args = ModelArguments(pooling="mean", normalize=True)
    jmodel, params = jbi.DRModel.build(args, jax.random.key(11), bert_config=CFG)
    jmodel.save(params, ckpt)
    p_batches = _batches(150, 48, 1, "d")
    q_batches = _batches(20, 12, 2, "q")

    def jax_encode(batches, fn):
        out = []
        for _, batch in batches:
            padded, valid = pad_to_batch(batch, BS)
            out.append(np.asarray(fn(params, jax.tree.map(jnp.asarray, padded)))[:valid])
        return np.concatenate(out)

    port = DRModelForInference.build(ModelArguments(model_name_or_path=ckpt, attention="fused"),
                                     device="cpu")
    jp, jq = jax_encode(p_batches, jmodel.encode_passage), jax_encode(q_batches, jmodel.encode_query)
    tp, p_lookup = encode_batches(port, p_batches, "passage", BS)
    tq, q_lookup = encode_batches(port, q_batches, "query", BS)
    return dict(jp=jp, jq=jq, tp=tp, tq=tq, p_lookup=p_lookup, q_lookup=q_lookup)


def test_encode_matches(slice_run):
    r = slice_run
    assert r["tp"].shape == r["jp"].shape == (150, 64)
    np.testing.assert_allclose(r["tp"], r["jp"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(r["tq"], r["jq"], rtol=2e-5, atol=2e-5)
    assert r["p_lookup"][:3] == ["d0", "d1", "d2"] and len(r["q_lookup"]) == 20


def test_search_and_metrics_match(slice_run):
    r = slice_run
    js, ji = jflat.FlatIPIndex(r["jp"]).search(r["jq"], k=20)
    ts, ti = tflat.FlatIPIndex(r["tp"], device="cpu").search(r["tq"], k=20)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(3)
    qrels = [set(rng.choice(150, 8, replace=False).tolist()) | {int(ji[q, 2])}
             for q in range(20)]

    def hits(ids):
        return np.array([[int(d) in qrels[q] for d in row] for q, row in enumerate(ids)])

    topk = [1, 5, 20]
    assert get_metrics(hits(ti), topk) == get_metrics(hits(ji), topk)


def test_index_files_interchange(slice_run, tmp_path):
    r = slice_run
    jidx = jflat.FlatIPIndex(r["jp"], dtype="bfloat16")
    jidx.docid = list(r["p_lookup"])
    jidx.save(str(tmp_path / "jax_index"))
    tidx = tflat.FlatIPIndex.load(str(tmp_path / "jax_index"), device="cpu")
    assert tidx.dtype == "bfloat16" and tidx.docid == r["p_lookup"] and len(tidx) == 150
    np.testing.assert_array_equal(tidx.search(r["jq"], 10)[1], jidx.search(r["jq"], 10)[1])

    tidx = tflat.FlatIPIndex(64, device="cpu")
    tidx.add(r["tp"][:70])
    tidx.add(r["tp"][70:])
    tidx.docid = list(r["p_lookup"])
    tidx.save(str(tmp_path / "port_index"))
    back = jflat.FlatIPIndex.load(str(tmp_path / "port_index"))
    assert back.docid == r["p_lookup"] and len(back) == 150
    np.testing.assert_array_equal(back.search(r["tq"], 10)[1], tidx.search(r["tq"], 10)[1])


def test_retrieval_cli_writes_same_ranking(slice_run, tmp_path):
    r = slice_run
    for i, (lo, hi) in enumerate([(0, 90), (90, 150)]):
        with open(tmp_path / f"p{i}.pkl", "wb") as fh:
            pickle.dump((r["tp"][lo:hi], r["p_lookup"][lo:hi]), fh)
    with open(tmp_path / "q.pkl", "wb") as fh:
        pickle.dump((r["tq"], r["q_lookup"]), fh)
    shards = str(tmp_path / "p*.pkl")
    assert len(glob.glob(shards)) == 2
    jret.run(str(tmp_path / "q.pkl"), shards, str(tmp_path / "jax.tsv"), depth=15,
             batch_size=8, save_text=True)
    tret.run(str(tmp_path / "q.pkl"), shards, str(tmp_path / "port.tsv"), depth=15,
             batch_size=8, save_text=True, device="cpu")

    def read(name):
        with open(os.path.join(str(tmp_path), name)) as fh:
            rows = [line.split("\t") for line in fh.read().splitlines()]
        return [(q, d) for q, d, _ in rows], np.array([float(s) for _, _, s in rows])

    (jpairs, jscores), (tpairs, tscores) = read("jax.tsv"), read("port.tsv")
    assert tpairs == jpairs and len(tpairs) == 20 * 15
    np.testing.assert_allclose(tscores, jscores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "serve", "i8q", "approx"])
def test_int8_search_and_metrics_match(slice_run, mode):
    """The slice's reps into an int8 index on both packages, every mode (the
    exact scan on the CPU): ids equal, scores within 1e-5, same metrics."""
    r = slice_run
    js, ji = jflat.FlatIPIndex(r["jp"], dtype="int8").search(r["jq"], k=20, mode=mode)
    ts, ti = tflat.FlatIPIndex(r["tp"], dtype="int8", device="cpu").search(r["tq"], k=20,
                                                                          mode=mode)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    hits = np.array([[int(d) % 7 == q % 7 for d in row] for q, row in enumerate(ti)])
    jhits = np.array([[int(d) % 7 == q % 7 for d in row] for q, row in enumerate(ji)])
    assert get_metrics(hits, [1, 5, 20]) == get_metrics(jhits, [1, 5, 20])


def _write_shards(r, tmp_path):
    for i, (lo, hi) in enumerate([(0, 90), (90, 150)]):
        with open(tmp_path / f"p{i}.pkl", "wb") as fh:
            pickle.dump((r["tp"][lo:hi], r["p_lookup"][lo:hi]), fh)
    with open(tmp_path / "q.pkl", "wb") as fh:
        pickle.dump((r["tq"], r["q_lookup"]), fh)
    return str(tmp_path / "q.pkl"), str(tmp_path / "p*.pkl")


def _read(path):
    with open(path) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()]
    return [(q, d) for q, d, _ in rows], np.array([float(s) for _, _, s in rows])


@pytest.mark.parametrize("mode", ["serve", "i8q", "exact"])
def test_retrieval_cli_int8_same_ranking(slice_run, tmp_path, mode):
    """``--index_dtype int8 --search_mode serve|i8q|exact`` on both packages, and
    the port serving a saved int8 index through ``--index_path``."""
    r = slice_run
    qpath, shards = _write_shards(r, tmp_path)
    jret.run(qpath, shards, str(tmp_path / "jax.tsv"), depth=15, batch_size=8, save_text=True,
             index_dtype="int8", search_mode=mode)
    tret.run(qpath, shards, str(tmp_path / "port.tsv"), depth=15, batch_size=8, save_text=True,
             index_dtype="int8", search_mode=mode, device="cpu")
    (jpairs, jscores), (tpairs, tscores) = _read(tmp_path / "jax.tsv"), _read(tmp_path / "port.tsv")
    assert tpairs == jpairs and len(tpairs) == 20 * 15
    np.testing.assert_allclose(tscores, jscores, rtol=1e-5, atol=1e-5)

    idx = tflat.FlatIPIndex(64, dtype="int8", device="cpu")
    idx.add_device(torch.from_numpy(r["tp"]))
    idx.docid = list(r["p_lookup"])
    idx.save(str(tmp_path / "int8_index"))
    tret.run(qpath, save_ranking_to=str(tmp_path / "saved.tsv"), depth=15, batch_size=8,
             save_text=True, search_mode=mode, index_path=str(tmp_path / "int8_index"),
             device="cpu")
    assert _read(tmp_path / "saved.tsv")[0] == jpairs


def test_retrieval_cli_runs_on_the_card(slice_run, tmp_path):
    """``main`` builds its index on the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main runs there")
    qpath, shards = _write_shards(slice_run, tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tret.main(["--query_reps", qpath, "--passage_reps", shards, "--save_ranking_to",
                   str(tmp_path / "port.tsv"), "--index_dtype", "int8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DRModelForInference.build(ModelArguments())

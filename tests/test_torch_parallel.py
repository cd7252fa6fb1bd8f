"""The port's data parallelism and sharded indexes against the JAX package's mesh, on the CPU.

A world of N ranks is N ``gloo`` processes (``tests/torch_dist_worker.py``,
which imports only the port) on a free local port; the JAX side runs in this
process on ``make_mesh(N, 1, devices=jax.devices()[:N])`` over
``tests/conftest.py``'s 8 CPU devices. Each world is spawned once per module
(a fixture), every worker with a timeout: a worker that fails or hangs fails
the tests that read it, and is killed. Inputs are made here with numpy from a
seed and written to the world's directory.
"""

import json
import os
import random
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseretrievaltoolkits_tpu.config import RRTrainingArguments as JRRArgs
from denseretrievaltoolkits_tpu.config import TrainingArguments as JArgs
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.models import reranker as jrr
from denseretrievaltoolkits_tpu.parallel.mesh import make_mesh as jmake_mesh
from denseretrievaltoolkits_tpu.parallel.sharded_index import ShardedFlatIndex as JFlat
from denseretrievaltoolkits_tpu.parallel.sharded_ivf import sharded_index_factory as jfactory
from denseretrievaltoolkits_tpu.train.trainer import RRTrainer as JRRTrainer
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JTrainer
from denseretrievaltoolkits_tpu.utils.distributed import host_corpus_bounds as jbounds
from denseretrievaltoolkits_torch import run_random_sampling as port_entry
from denseretrievaltoolkits_torch.config import ModelArguments
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models.convert import params_to_jax
from denseretrievaltoolkits_torch.parallel.mesh import make_mesh
from denseretrievaltoolkits_torch.utils.distributed import host_corpus_bounds, process_shard

import torch_dist_worker as W
from helpers import make_exactmatch_dataset, make_tokenizer
from test_torch_ivf import _quantum, _same_up_to_ties

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
WORLD_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(case: str, world: int, work) -> list:
    """Run ``case`` on ``world`` worker processes; their readings by rank. A
    worker that exits non-zero or outlives WORLD_TIMEOUT_S fails the caller
    (every worker is killed first), with its log."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(WORKER) + os.pathsep
               + os.path.dirname(os.path.dirname(WORKER)), HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1", HF_DATASETS_OFFLINE="1")
    port = str(_free_port())
    logs = [open(os.path.join(work, f"{case}.rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), port, str(work)],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    failed = None
    try:
        for r, p in enumerate(procs):
            try:
                if p.wait(timeout=WORLD_TIMEOUT_S) != 0 and failed is None:
                    failed = f"rank {r} exited {p.returncode}"
            except subprocess.TimeoutExpired:
                failed = f"rank {r} still running after {WORLD_TIMEOUT_S} s"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    if failed:
        tails = []
        for r in range(world):
            with open(os.path.join(work, f"{case}.rank{r}.log")) as fh:
                tails.append(f"--- rank {r}\n" + fh.read()[-3000:])
        pytest.fail(f"{case} x{world}: {failed}\n" + "\n".join(tails))
    return [dict(np.load(os.path.join(work, f"{case}.rank{r}.npz"))) for r in range(world)]


def _jmesh(n):
    return jmake_mesh(n, 1, devices=jax.devices()[:n])


# --- bounds and the mesh ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 5, 777, 1000, 1003])
def test_host_corpus_bounds_match_jax(n):
    """Every (world, rank) window of n rows, and the windows tile [0, n)."""
    for world in (1, 2, 3, 4, 8):
        spans = [host_corpus_bounds(n, world, r) for r in range(world)]
        assert spans == [jbounds(n, n_proc=world, proc_idx=r, local_shards=1)
                         for r in range(world)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_mesh_without_a_process_group():
    """One rank: collectives return their inputs, and the loaders load every row."""
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1, "model": 1})
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(torch.cat(mesh.all_gather(x)), x) and torch.equal(mesh.mean(x), x)
    assert process_shard() == (1, 0)
    with pytest.raises(ValueError, match="world size"):
        make_mesh(dp_size=2)
    with pytest.raises(ValueError, match="tp_size 2 must divide the world size 1"):
        make_mesh(1, 2)


# --- the sharded indexes ----------------------------------------------------------------------

SPECS = {"IVF8,SQ8": ("exact", "bulk"), "IVFR8,Flat": ("exact", "bulk"),
         "PQ16": ("exact", "serve"), "IVF8,PQ16": ("exact", "bulk"), "PCAR32,SQ8": ("exact",)}

def _clustered(rng, n_clusters=24, per=40, dim=128, spread=0.12):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    x = np.concatenate([c + spread * rng.normal(size=(per, dim)).astype(np.float32)
                        for c in centers])
    rng.shuffle(x)
    return x


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def index_world(request, tmp_path_factory):
    """The JAX package's sharded indexes on an N-device mesh (searched, and saved
    for the port to load), then N port ranks over the same rows."""
    world = request.param
    work = tmp_path_factory.mktemp(f"index{world}")
    rng = np.random.default_rng(21)
    corpus = rng.normal(size=(1003, 64)).astype(np.float32)
    queries = rng.normal(size=(16, 64)).astype(np.float32)
    tiny = rng.normal(size=(world - 1, 16)).astype(np.float32)
    big = _clustered(rng)
    big_q = big[rng.choice(len(big), 24, replace=False)] + \
        0.05 * rng.normal(size=(24, 128)).astype(np.float32)
    np.savez(work / "index_inputs.npz", corpus=corpus, queries=queries, tiny=tiny,
             clustered=big, clustered_queries=big_q)
    mesh = _jmesh(world)
    ref = {}
    for dtype in W.FLAT_DTYPES:
        idx = JFlat(mesh, 64, dtype=dtype, block_size=64)
        idx.add(corpus)
        # off the TPU the JAX index serves every mode by the exact scan (sharded_index.py:239)
        ref[f"flat/{dtype}"] = idx.search(queries, W.K, mode="exact")
        idx.save(str(work / f"jax_flat_{dtype}"))
    windows = [host_corpus_bounds(len(big), world, r) for r in range(world)]
    sample = np.concatenate([big[a:b][::2] for a, b in windows])
    for spec, modes in SPECS.items():
        key = spec.replace(",", "_")
        idx = jfactory(mesh, 128, spec, nprobe=4)
        idx.train(sample)
        idx.add(big)
        for mode in modes:
            ref[f"{key}/{mode}"] = idx.search(big_q, W.K, mode=mode)
        idx.save(str(work / f"jax_{key}"))
    outs = run_world("index", world, work)
    return world, work, ref, outs, (corpus, queries, tiny, big, big_q)


def _same_on_every_rank(outs, key):
    for other in outs[1:]:
        np.testing.assert_array_equal(other[key], outs[0][key], err_msg=key)
    return outs[0][key]


@pytest.mark.parametrize("dtype", W.FLAT_DTYPES)
def test_sharded_flat_matches_jax_mesh(index_world, dtype):
    """Every mode, rows staged by ``add`` or by two ``add_device`` slabs (int8 /
    int4 quantized as the slabs arrive): the JAX mesh's exact top-k ids and
    scores within the flat index's 1e-5 (on the CPU every mode is the exact
    scan on both sides, so serve and i8q meet their recall contract at 1.0),
    the same on every rank."""
    world, work, ref, outs, _ = index_world
    js, ji = ref[f"flat/{dtype}"]
    for mode in ("exact", "serve") + (("i8q",) if dtype in ("int8", "int4") else ()):
        for how in ("add", "add_device"):
            ti = _same_on_every_rank(outs, f"flat/{dtype}/{how}/{mode}/i")
            ts = _same_on_every_rank(outs, f"flat/{dtype}/{how}/{mode}/s")
            np.testing.assert_array_equal(ti, ji, err_msg=f"{how} {mode}")
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5, err_msg=f"{how} {mode}")


@pytest.mark.parametrize("dtype", W.FLAT_DTYPES)
def test_sharded_flat_saves_load_in_both_packages(index_world, dtype):
    """The port loads the JAX mesh's save (one file) and the JAX package loads the
    port's (one part a rank), each with the other's exact top-k."""
    world, work, ref, outs, (corpus, queries, *_) = index_world
    js, ji = ref[f"flat/{dtype}"]
    np.testing.assert_array_equal(_same_on_every_rank(outs, f"flat/{dtype}/from_jax/i"), ji)
    with open(work / f"port_flat_{dtype}.meta.json") as fh:
        assert len(json.load(fh)["parts"]) == world
    back = JFlat.load(str(work / f"port_flat_{dtype}"), _jmesh(world))
    s, i = back.search(queries, W.K)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-5)


def test_sharded_flat_empty_shard(index_world):
    """Fewer rows than ranks: the last rank holds none; the search and a save /
    load round trip still give the exact top-k."""
    world, work, ref, outs, (_, queries, tiny, *_) = index_world
    full = queries[:, :tiny.shape[1]] @ tiny.T
    want = np.argsort(-full, axis=1, kind="stable")[:, :min(W.K, len(tiny))]
    np.testing.assert_array_equal(_same_on_every_rank(outs, "tiny/i"), want)
    np.testing.assert_array_equal(_same_on_every_rank(outs, "tiny/reloaded/i"), want)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_sharded_trained_kinds_match_jax_mesh(index_world, spec):
    """IVF (ragged SQ8 / Flat cells), PQ, IVF-PQ and a PCAR chain from the mesh
    factory: exact mode gives the JAX mesh's exact top-k where the stored rows do
    not depend on the fit (flat and SQ8 cells); the JAX mesh's save loads and
    searches to the JAX ids in every mode: exact ids equal and scores within
    1e-5, bulk / serve ids equal up to ties within two quanta of the JAX packed
    selection's 512-row block (``tests/test_torch_ivf.py:_same_up_to_ties``,
    PQ codes tie often); the port's own save reloads to its own ids; the
    port's bulk / serve reach recall@20 >= 0.9 of its exact search, as the JAX
    tests hold their sharded searches to the one-device ones."""
    world, work, ref, outs, _ = index_world
    key = spec.replace(",", "_")
    modes = SPECS[spec]
    for mode in modes:
        js, ji = ref[f"{key}/{mode}"]
        ti = _same_on_every_rank(outs, f"{key}/from_jax/{mode}/i")
        ts = _same_on_every_rank(outs, f"{key}/from_jax/{mode}/s")
        if mode == "exact":
            np.testing.assert_array_equal(ti, ji, err_msg=mode)
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5, err_msg=mode)
        else:
            _same_up_to_ties(ts, ti, js, ji, 2 * _quantum(512))
    own_exact = _same_on_every_rank(outs, f"{key}/exact/i")
    if spec in ("IVF8,SQ8", "IVFR8,Flat"):
        np.testing.assert_array_equal(own_exact, ref[f"{key}/exact"][1])
    np.testing.assert_array_equal(_same_on_every_rank(outs, f"{key}/reloaded/i"),
                                  _same_on_every_rank(outs, f"{key}/{modes[-1]}/i"))
    approx = _same_on_every_rank(outs, f"{key}/{modes[-1]}/i")
    recall = np.mean([len(set(a) & set(b)) / W.K for a, b in zip(approx, own_exact)])
    assert recall >= 0.9, recall


def test_collective_pca_equals_one_process_fit(index_world):
    """Every rank's CollectivePCATransform matrix is bit for bit the one
    process's PCATransform fitted on the gathered sample."""
    _, _, _, outs, _ = index_world
    np.testing.assert_array_equal(_same_on_every_rank(outs, "pca/collective"),
                                  outs[0]["pca/one"])


# --- the data-parallel step -------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    work = tmp_path_factory.mktemp("train2")
    tbert.save_config(tbert.BertConfig(**dict(W.CFG, vocab_size=96)), str(work / "rr_arch"))
    return work, run_world("train", 2, work)


def _jax_side(port):
    """The JAX model and params of a port dual encoder (tied, no heads)."""
    s = port.spec
    jmodel = jbi.DRModel(jbi.DRModelSpec(bert_config=jbert.BertConfig(**W.CFG), tied=s.tied,
                                         pooling=s.pooling, attention=s.attention,
                                         fused_loss=s.fused_loss))
    return jmodel, jax.tree.map(jnp.asarray, {"lm_q": params_to_jax(port.lm_q.state_dict())})


def _jargs(tmp, **kw):
    base = dict(output_dir=str(tmp / "out"), cache_train_dir=str(tmp / "cache"),
                learning_rate=3e-3, optimizer="adamw", log_every=0, save_per_train=10)
    base.update(kw)
    return JArgs(**base)


def _port_params(out, prefix, module):
    """A rank's saved tower parameters, as the JAX tree's flat keys."""
    sd = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in out.items()
          if k.startswith(prefix + "/")}
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(params_to_jax(sd))[0]}


def _jax_flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _global_batch():
    return W.token_batch(8, 8, 1), W.token_batch(16, 12, 2)


def _ranks_bit_equal(outs, prefix):
    for k in outs[0]:
        if k.startswith(prefix + "/"):
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)


def test_dp_step_matches_jax_mesh(train_world, tmp_path):
    """2 ranks x (4 queries, 8 passages) against the JAX Trainer's step on a
    2-device mesh over the global 8 x 16 batch from the same weights (global
    negatives, K3 / K4 over Q = 8, P = 16 on each rank): 2 sgd steps' losses
    within the trajectory test's 1e-5 relative + 2e-6, the parameters within
    1e-5 relative + 5e-5, and bit-equal on the two ranks. SGD, as the grad-cache
    tests compare: Adam's first step lifts the fp32 noise of a gradient that is 0
    in exact arithmetic (the k bias) to a share of lr."""
    _, outs = train_world
    port = W.build_model()
    jmodel, jparams = _jax_side(port)
    jt = JTrainer(_jargs(tmp_path, optimizer="sgd", learning_rate=0.1), jmodel, jparams,
                  mesh=_jmesh(2))
    ref = [float(jt.train_step(_global_batch())) for _ in range(2)]
    np.testing.assert_array_equal(outs[1]["global_losses"], outs[0]["global_losses"])
    np.testing.assert_allclose(outs[0]["global_losses"], ref, rtol=1e-5, atol=2e-6)
    _ranks_bit_equal(outs, "global")
    got = _port_params(outs[0], "global", port.lm_q)
    want = _jax_flat(jt.state["params"]["lm_q"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-5, err_msg=k)


def test_dp_local_negatives_match_jax_mesh(train_world, tmp_path):
    """negatives_x_device off: the loss is the mean over ranks of each rank's own
    block loss, as the JAX mesh's shard_map step (tests/test_parallel.py:162), and
    differs from the global one."""
    _, outs = train_world
    port = W.build_model()
    jmodel, jparams = _jax_side(port)
    jt = JTrainer(_jargs(tmp_path, negatives_x_device=False), jmodel, jparams, mesh=_jmesh(2))
    ref = float(jt.train_step(_global_batch()))
    for out in outs:
        np.testing.assert_allclose(float(out["local_loss"]), ref, rtol=1e-5, atol=2e-6)
    assert abs(float(outs[0]["local_loss"]) - float(outs[0]["global_losses"][0])) > 1e-3


def test_dp_grad_cache_matches_jax_mesh(train_world, tmp_path):
    """Grad-cache under the mesh (chunks of 2 queries / 4 passages a rank): one
    sgd step at lr 1 against the JAX grad-cache step on the 2-device mesh: the
    loss within 1e-5, the parameters (moved by the gradient) within the
    grad-cache test's 1e-4 relative + 5e-5."""
    _, outs = train_world
    port = W.build_model()
    jmodel, jparams = _jax_side(port)
    jt = JTrainer(_jargs(tmp_path, optimizer="sgd", learning_rate=1.0, grad_cache=True,
                         gc_q_chunk_size=4, gc_p_chunk_size=8), jmodel, jparams, mesh=_jmesh(2))
    ref = float(jt.train_step(_global_batch()))
    np.testing.assert_allclose(float(outs[0]["gc_loss"]), ref, rtol=1e-5)
    _ranks_bit_equal(outs, "gc")
    got = _port_params(outs[0], "gc", port.lm_q)
    want = _jax_flat(jt.state["params"]["lm_q"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=5e-5, err_msg=k)


def test_rrtrainer_on_mesh_matches_jax_mesh(train_world, tmp_path):
    """RRTrainer with 4 (pos, neg) pairs a rank against the JAX RRTrainer on a
    2-device mesh over the 8 pairs (tests/test_parallel.py:195): 2 sgd steps'
    losses within 1e-5 + 2e-6 and the parameters within 1e-5 + 5e-5, bit-equal
    on the two ranks."""
    from denseretrievaltoolkits_torch.config import RRTrainingArguments
    from denseretrievaltoolkits_torch.models.reranker import RRModel

    work, outs = train_world
    margs = ModelArguments(model_name_or_path=str(work / "rr_arch"), pooling="first",
                           pos_token="yes", neg_token="no")
    targs = RRTrainingArguments(output_dir=str(tmp_path / "o"), cache_train_dir=str(tmp_path),
                                loss_fn="mr", margin=0.7)
    port = RRModel.build(margs, train_args=targs, tokenizer=W.RRTok(), device="cpu", seed=3)
    s = port.spec
    jmodel = jrr.RRModel(jrr.RRModelSpec(
        bert_config=jbert.BertConfig(**dict(W.CFG, vocab_size=96)), pooling=s.pooling,
        loss_fn="mr", margin=0.7))
    jparams = {"lm": params_to_jax(port.lm.state_dict())}
    if port.head is not None:
        jparams["head"] = {"kernel": port.head.kernel.detach().numpy().copy()}
    jt = JRRTrainer(JRRArgs(output_dir=str(tmp_path / "j"), cache_train_dir=str(tmp_path / "jc"),
                            loss_fn="mr", margin=0.7, optimizer="sgd", learning_rate=1e-2,
                            log_every=0, save_per_train=10),
                    jmodel, jax.tree.map(jnp.asarray, jparams), mesh=_jmesh(2))
    ref = [float(jt.train_step((W.token_batch(8, 12, 10 + i), W.token_batch(8, 12, 20 + i))))
           for i in range(2)]
    np.testing.assert_array_equal(outs[1]["rr_losses"], outs[0]["rr_losses"])
    np.testing.assert_allclose(outs[0]["rr_losses"], ref, rtol=1e-5, atol=2e-6)
    _ranks_bit_equal(outs, "rr")
    got = _port_params(outs[0], "rr", port.lm)
    want = _jax_flat(jt.state["params"]["lm"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=5e-5, err_msg=k)


# --- evaluation, the loaders' windows and the entry point on the mesh --------------------------

@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    """The evaluation data (helpers' ExactMatch set, 48 passages) and a noisy
    tiny model in the deploy format; 2 ranks evaluate, then run
    ``run_random_sampling.main`` over their process group."""
    from denseretrievaltoolkits_torch.models import biencoder as tbi

    work = tmp_path_factory.mktemp("eval2")
    tokenizer = make_tokenizer(work)
    tok_dir = str(work / "tok")
    tokenizer.save_pretrained(tok_dir)
    data_dir, corpus_path, _, _ = make_exactmatch_dataset(work, random.Random(0), n_train=16,
                                                          n_eval=8, n_corpus=48, n_neg=3)
    cfg = tbert.BertConfig(vocab_size=tokenizer.vocab_size, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=64,
                           max_position_embeddings=48)
    model = tbi.DRModel.build(ModelArguments(), bert_config=cfg, seed=11, device="cpu")
    # random-init CLS reps score every passage within ~1e-5: spread them (tests/test_torch_eval)
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_(torch.from_numpy(0.3 * rng.standard_normal(prm.shape).astype(np.float32)))
    model.save(str(work / "model"))
    data_args = dict(data_dir=data_dir, corpus_path=corpus_path, train_n_passages=2,
                     q_max_len=16, p_max_len=24, data_cache_dir=str(work / "hf"),
                     positive_passage_no_shuffle=True, negative_passage_no_shuffle=True)
    entry_argv = ["--model_name_or_path", str(work / "model"), "--tokenizer_name", tok_dir,
                  "--dataset", "nq", "--data_dir", data_dir, "--corpus_path", corpus_path,
                  "--data_cache_dir", str(work / "hf"), "--train_n_passages", "2",
                  "--positive_passage_no_shuffle", "--negative_passage_no_shuffle",
                  "--q_max_len", "16", "--p_max_len", "24", "--eval_batch_size", "8",
                  "--test_batch_size", "8", "--corpus_batch_size", "8", "--max_epochs", "1",
                  "--eval_per_train", "1", "--save_per_train", "1", "--learning_rate", "1e-3",
                  "--topk", "1,5", "--retrieve_num", "5", "--log_every", "1", "--seed", "3"]
    with open(work / "eval.json", "w") as fh:
        json.dump({"tok_dir": tok_dir, "model_dir": str(work / "model"), "data_args": data_args,
                   "entry_argv": entry_argv + ["--train_batch_size", "4"]}, fh)
    # the one-process evaluations first: they also fill the datasets cache the ranks read
    one = W.run_evaluations(str(work), "one", None, *W.eval_setup(str(work)))
    return work, entry_argv, run_world("evaluate", 2, work), one


def test_corpus_loader_windows(eval_world):
    """``CorpusDataloader(shard_hosts=True)``: each rank iterates its contiguous
    ``host_corpus_bounds`` window, the JAX formula's."""
    _, _, outs, _ = eval_world
    for r, out in enumerate(outs):
        a, b = jbounds(48, n_proc=2, proc_idx=r, local_shards=1)
        np.testing.assert_array_equal(out["window"], np.arange(a, b))


@pytest.mark.parametrize("name", [n for n, _ in W.EVAL_CONFIGS])
def test_evaluate_on_mesh_matches_one_process(eval_world, name):
    """``Trainer.evaluate`` over 2 ranks' corpus windows (flat fp32 exact,
    IVFR8,SQ8 bulk, PQ8 exact, and the transformed kinds PCAR16,SQ8 and
    OPQ4,PQ4 exact): the metrics are equal on both ranks and
    equal to the one-process evaluation's (the trained kinds fit on the same
    gathered sample); rank 0 alone wrote the dump and the metrics, and the saved
    sharded index reloads through ``_load_index``."""
    work, _, outs, one_process_metrics = eval_world
    per_rank = [json.loads(str(out["metrics"])) for out in outs]
    assert per_rank[0][name] == per_rank[1][name] == one_process_metrics[name]
    assert per_rank[0][name]["query_num"] == 8
    ep = [n for n, _ in W.EVAL_CONFIGS].index(name) + 1
    assert sorted(os.listdir(work / f"mesh-{name}" / "cache" / "retrieve")) == [f"{ep}.0.json"]
    if name == "flat":
        assert per_rank[0]["flat_reloaded_rows"] == per_rank[1]["flat_reloaded_rows"] == 48


@pytest.mark.parametrize("mode", W.MINE_MODES)
def test_dense_miner_on_mesh(eval_world, mode):
    """``DenseMiner`` over the mesh evaluation's sharded flat index (its
    collective search, ``trainer.idx`` in dataset order): the mined train rows
    are the same on both ranks and the same as the one-process miner's."""
    _, _, outs, one_process_metrics = eval_world
    per_rank = [json.loads(str(out["metrics"]))[f"mined/{mode}"] for out in outs]
    want = one_process_metrics[f"mined/{mode}"]
    assert per_rank[0] == per_rank[1] == json.loads(json.dumps(want))
    assert len(want) == 16


def _entry_run(base):
    """(per-step losses, {metrics file: metrics}) of an entry-point run."""
    with open(base / "out" / "train_log.jsonl") as fh:
        losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
    metrics = {}
    for name in sorted(os.listdir(base / "cache")):
        if name.endswith("_metrics"):
            with open(base / "cache" / name) as fh:
                metrics[name] = json.load(fh)
    return losses, metrics


def _same_entry_runs(mesh_run, one_run, steps, metric_files):
    (m_losses, m_metrics), (o_losses, o_metrics) = mesh_run, one_run
    assert len(m_losses) == len(o_losses) == steps
    np.testing.assert_allclose(m_losses, o_losses, rtol=1e-5, atol=2e-6)
    assert sorted(m_metrics) == sorted(o_metrics) == metric_files
    for name in m_metrics:
        assert m_metrics[name]["query_num"] == o_metrics[name]["query_num"] == 8
        for key, value in m_metrics[name].items():
            assert value == pytest.approx(o_metrics[name][key], abs=1e-6), (name, key)


def _one_process_entry(entry_argv, root, extra=()):
    port_entry.main(entry_argv + list(extra) + ["--train_batch_size", "8",
                                                "--output_dir", str(root / "out"),
                                                "--cache_train_dir", str(root / "cache")],
                    device="cpu")
    return _entry_run(root)


def test_entry_point_on_two_processes(eval_world, tmp_path):
    """``run_random_sampling.main`` over the 2 ranks' process group for one
    epoch (4 queries a rank, the train set strided over the ranks) against one
    process at the global batch of 8 from the same weights: the same per-step
    losses within 1e-5 + 2e-6 (the gathered batch holds the same queries in
    another order) and the same dev and test metrics."""
    work, entry_argv, _, _ = eval_world
    _same_entry_runs(_entry_run(work / "entry"), _one_process_entry(entry_argv, tmp_path / "one"),
                     2, ["-1.0_metrics", "1.0_metrics"])


def test_entry_point_tensor_parallel(eval_world, tmp_path):
    """``run_random_sampling.main --tp_size 2`` over the 2 ranks: one data rank of two
    model ranks, each BERT layer cut over them, the global batch of 8 on both. The
    per-step losses and the dev and test metrics equal one process's at the same
    batch (losses within 1e-5 + 2e-6); rank 0 alone wrote them, and the deploy
    format it wrote from the gathered parts loads in one process."""
    from denseretrievaltoolkits_torch.models.biencoder import DRModel

    work, entry_argv, _, _ = eval_world
    _same_entry_runs(_entry_run(work / "entry_tp"),
                     _one_process_entry(entry_argv, tmp_path / "one"),
                     2, ["-1.0_metrics", "1.0_metrics"])
    model = DRModel.build(ModelArguments(model_name_or_path=str(work / "entry_tp" / "cache"
                                                                / "result1")), device="cpu")
    one = DRModel.build(ModelArguments(model_name_or_path=str(tmp_path / "one" / "cache"
                                                              / "result1")), device="cpu")
    H = model.spec.bert_config.hidden_size
    for (k, a), b in zip(model.state_dict().items(), one.state_dict().values()):
        a, b = a.numpy(), b.numpy()
        if k.endswith("qkv_bias"):  # the k bias: fp32 noise that adamw lifts to +-lr a step
            np.testing.assert_allclose(a[H:2 * H], b[H:2 * H], atol=2 * 2e-3, err_msg=k)
            a, b = np.concatenate([a[:H], a[2 * H:]]), np.concatenate([b[:H], b[2 * H:]])
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-5, err_msg=k)
    assert sorted(os.listdir(work / "entry_tp" / "out" / "checkpoint" / "ep1")) == \
        ["state.tp0.pt", "state.tp1.pt"]


@pytest.fixture(scope="module")
def eval_world_tp(eval_world):
    """The evaluation data on 4 ranks as a dp = 2, tp = 2 mesh (worker case
    ``evaluate_tp``)."""
    return run_world("evaluate_tp", 4, eval_world[0])


def test_evaluate_and_entry_point_at_dp2_tp2(eval_world, eval_world_tp, tmp_path):
    """dp = 2, tp = 2 over 4 ranks: each rank encodes its data rank's corpus window
    with its model rank's half of every BERT layer. The flat and IVFR8,SQ8 indexes
    shard over the data axis, and model rank 0's ranks alone save them (the save
    ends in a barrier of their data group, which model rank 1 does not enter): the
    metrics on every rank equal one process's within 1e-6, the saved flat index
    reloads, and the miner mines the one-process rows. ``run_random_sampling.main
    --tp_size 2`` then trains two data shards of 4 and evaluates: its losses and
    metrics equal one process's at the global batch of 8 (losses within 1e-5 +
    2e-6), and each model rank wrote its checkpoint's parts."""
    work, entry_argv, _, one = eval_world
    for r, out in enumerate(eval_world_tp):
        a, b = jbounds(48, n_proc=2, proc_idx=r // 2, local_shards=1)
        np.testing.assert_array_equal(out["window"], np.arange(a, b))
        metrics = json.loads(str(out["metrics"]))
        for name, _ in W.EVAL_CONFIGS[:2]:
            assert metrics[name]["query_num"] == 8
            for key, value in metrics[name].items():
                assert value == pytest.approx(one[name][key], abs=1e-6), (r, name, key)
        for mode in W.MINE_MODES:
            assert metrics[f"mined/{mode}"] == json.loads(json.dumps(one[f"mined/{mode}"]))
        assert metrics["flat_reloaded_rows"] == 48
    assert sorted(os.listdir(work / "mesh_tp-flat" / "cache" / "retrieve")) == ["1.0.json"]
    _same_entry_runs(_entry_run(work / "entry_dp2tp2"),
                     _one_process_entry(entry_argv, tmp_path / "one"),
                     2, ["-1.0_metrics", "1.0_metrics"])
    assert sorted(os.listdir(work / "entry_dp2tp2" / "out" / "checkpoint" / "ep1")) == \
        ["state.tp0.pt", "state.tp1.pt"]


def test_mining_hook_on_two_processes(eval_world, tmp_path):
    """The ``--mine_per_train 1`` hook over the 2 ranks for 2 epochs, the
    evaluation every 2: after epoch 1 each rank re-encodes its corpus window
    into the sharded index and mines the train set; epoch 2 trains on the mined
    rows. The per-step losses and the metrics equal one process's at the global
    batch, as without mining, so both ranks mined the one-process rows."""
    work, entry_argv, _, _ = eval_world
    _same_entry_runs(_entry_run(work / "entry_mine"),
                     _one_process_entry(entry_argv, tmp_path / "one", W.MINE_ARGV),
                     4, ["-1.0_metrics", "2.0_metrics"])

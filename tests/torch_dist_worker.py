"""One rank of the multi-process CPU checks of ``tests/test_torch_parallel.py``.

    python tests/torch_dist_worker.py <case> <rank> <world> <port> <workdir>

starts a ``gloo`` process group on ``127.0.0.1:<port>`` (every collective
waits at most 120 s), runs ``CASES[case]`` on the CPU with the inputs the
test wrote to ``<workdir>``, and writes its readings to
``<workdir>/<case>.rank<rank>.npz``. It imports the port only (and numpy);
the test compares its readings with the JAX package's.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from denseretrievaltoolkits_torch.config import (DataArguments, ModelArguments,  # noqa: E402
                                                 RRTrainingArguments, TrainingArguments)
from denseretrievaltoolkits_torch.models import bert as tbert  # noqa: E402
from denseretrievaltoolkits_torch.models.biencoder import DRModel  # noqa: E402
from denseretrievaltoolkits_torch.parallel.mesh import make_mesh  # noqa: E402
from denseretrievaltoolkits_torch.utils.distributed import (  # noqa: E402
    host_corpus_bounds, maybe_initialize_distributed)

CFG = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=24)
RR_TOKENS = {"yes": 17, "no": 5}
FLAT_DTYPES = ("float32", "bfloat16", "int8", "int4")
K = 20


def build_model(seed=7, **kw):
    """The tiny dual encoder both the test and the workers build from ``seed``."""
    args = ModelArguments(fused_loss=True, **kw)
    return DRModel.build(args, bert_config=tbert.BertConfig(**CFG), seed=seed, device="cpu")


def token_batch(n, S, seed):
    """Ragged token batch: lengths 2..S, pad id 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG["vocab_size"], (n, S)).astype(np.int32)
    lens = rng.integers(2, S + 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return {"input_ids": np.where(mask == 1, ids, 0).astype(np.int32), "attention_mask": mask}


def rank_slice(batch, rank, world):
    n = batch["input_ids"].shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def train_args(work, label, **kw):
    base = dict(output_dir=os.path.join(work, label, "out"),
                cache_train_dir=os.path.join(work, label, "cache"), learning_rate=3e-3,
                optimizer="adamw", log_every=0, save_per_train=10)
    base.update(kw)
    return TrainingArguments(**base)


def state_of(module, prefix):
    return {f"{prefix}/{k}": v.detach().numpy().copy() for k, v in module.state_dict().items()}


class RRTok:
    """``encode(token, add_special_tokens=False)`` of a tokenizer with two known words."""

    def encode(self, text, add_special_tokens=True):
        return [RR_TOKENS[text], 1]


def case_train(work, mesh):
    """The data-parallel steps on this rank's slice of the global batches."""
    from denseretrievaltoolkits_torch.models.reranker import RRModel
    from denseretrievaltoolkits_torch.train.trainer import RRTrainer, Trainer

    r, w = mesh.rank, mesh.size
    out = {}
    q, p = token_batch(8, 8, 1), token_batch(16, 12, 2)
    batch = (rank_slice(q, r, w), rank_slice(p, r, w))
    # (a) global negatives: 2 sgd steps (adam would lift the fp32 noise of gradients that
    # are 0 in exact arithmetic, the k bias's, to a share of lr)
    trainer = Trainer(train_args(work, f"global{r}", optimizer="sgd", learning_rate=0.1),
                      build_model(), mesh=mesh)
    out["global_losses"] = np.array([float(trainer.train_step(batch)) for _ in range(2)])
    out.update(state_of(trainer.model.lm_q, "global"))
    # (b) each rank's own negatives: 1 step
    trainer = Trainer(train_args(work, f"local{r}", negatives_x_device=False), build_model(),
                      mesh=mesh)
    out["local_loss"] = np.array(float(trainer.train_step(batch)))
    # (c) grad-cache under the mesh: 1 sgd step at lr 1 (the parameters move by the gradient)
    trainer = Trainer(train_args(work, f"gc{r}", optimizer="sgd", learning_rate=1.0,
                                 grad_cache=True, gc_q_chunk_size=2, gc_p_chunk_size=4),
                      build_model(), mesh=mesh)
    out["gc_loss"] = np.array(float(trainer.train_step(batch)))
    out.update(state_of(trainer.model.lm_q, "gc"))
    # (d) the reranker: 2 sgd steps on (pos, neg) pairs
    margs = ModelArguments(model_name_or_path=os.path.join(work, "rr_arch"), pooling="first",
                           pos_token="yes", neg_token="no")
    rargs = RRTrainingArguments(output_dir=os.path.join(work, f"rr{r}", "out"),
                                cache_train_dir=os.path.join(work, f"rr{r}", "cache"),
                                loss_fn="mr", margin=0.7, optimizer="sgd", learning_rate=1e-2,
                                log_every=0, save_per_train=10)
    rr = RRModel.build(margs, train_args=rargs, tokenizer=RRTok(), device="cpu", seed=3)
    rtrainer = RRTrainer(rargs, rr, mesh=mesh)
    pairs = [(token_batch(8, 12, 10 + i), token_batch(8, 12, 20 + i)) for i in range(2)]
    out["rr_losses"] = np.array([float(rtrainer.train_step((rank_slice(a, r, w),
                                                             rank_slice(b, r, w))))
                                 for a, b in pairs])
    out.update(state_of(rr.lm, "rr"))
    return out


EVAL_CONFIGS = (("flat", dict(index_dtype="float32", search_mode="exact")),
                ("ivf", dict(index_factory="IVFR8,SQ8", nprobe=4, search_mode="bulk")),
                ("pq", dict(index_factory="PQ8", search_mode="exact")),
                ("pcar", dict(index_factory="PCAR16,SQ8", search_mode="exact")),
                ("opq", dict(index_factory="OPQ4,PQ4", search_mode="exact")))
MINE_MODES = ("serve", "exact")
MINE_ARGV = ["--mine_per_train", "1", "--max_epochs", "2", "--eval_per_train", "2"]
# the two ranks as one data rank of two model ranks, at the one-process batch of 8
TP_ENTRY_ARGV = ["--tp_size", "2", "--train_batch_size", "8"]


def eval_setup(work, shard_num=1, shard_idx=0, shard_hosts=False):
    """The test's ExactMatch data through the port's loaders: (dev loader,
    corpus loader, the test's spec, (tokenizer, data args, train samples) for
    the miner)."""
    from denseretrievaltoolkits_torch.data.datasets import CorpusDataset, ExactMatchDataset
    from denseretrievaltoolkits_torch.data.loaders import CorpusDataloader, ExactMatchDataloader
    from denseretrievaltoolkits_torch.data.samplers import RandomSampleNegatives
    from denseretrievaltoolkits_torch.utils.tokenization import load_tokenizer

    with open(os.path.join(work, "eval.json")) as fh:
        spec = json.load(fh)
    tokenizer = load_tokenizer(ModelArguments(tokenizer_name=spec["tok_dir"]))
    dargs = DataArguments(**spec["data_args"])
    factory = ExactMatchDataloader(dargs, ExactMatchDataset(dargs, tokenizer), tokenizer,
                                   RandomSampleNegatives(dargs, seed=0), batch_size=[4, 4, 4],
                                   shard_num=shard_num, shard_idx=shard_idx)
    _, dev, _ = factory.get_dataloader()
    corpus = CorpusDataloader(dargs, CorpusDataset(dargs, tokenizer), tokenizer, batch_size=8,
                              shard_hosts=shard_hosts).get_dataloader()
    return dev, corpus, spec, (tokenizer, dargs, list(factory.train_dataset))


def run_evaluations(work, label, mesh, dev, corpus, spec, mine_inputs, configs=EVAL_CONFIGS):
    """``Trainer.evaluate`` into each of ``configs``; {config: metrics}, and the
    files under the shared cache dirs. After the flat evaluation ``DenseMiner``
    mines the train samples from its index in each of MINE_MODES
    (``mined/<mode>``)."""
    from denseretrievaltoolkits_torch.mine.miner import DenseMiner
    from denseretrievaltoolkits_torch.train.trainer import Trainer

    model = DRModel.build(ModelArguments(model_name_or_path=spec["model_dir"]), device="cpu")
    metrics = {}
    for ep, (name, kw) in enumerate(configs, start=1):
        args = train_args(work, f"{label}-{name}", topk="1,5,10", retrieve_num=10,
                          index_train_rows=64, **kw)
        trainer = Trainer(args, model, corpus_dataloader=corpus, eval_loader=dev,
                          label_kind="answers", mesh=mesh)
        metrics[name] = trainer.evaluate(dev, ep)
        if name == "flat":  # the miner on this index; the saved index reloads
            tokenizer, dargs, train = mine_inputs
            for mode in MINE_MODES:
                metrics[f"mined/{mode}"] = DenseMiner(trainer, tokenizer, dargs,
                                                      search_mode=mode).mine(train)
            trainer.index = None
            trainer._load_index(ep)
            metrics["flat_reloaded_rows"] = len(trainer.index)
    return metrics


def case_evaluate(work, mesh):
    """``Trainer.evaluate`` on the mesh over this rank's corpus window, the
    windows themselves, and ``run_random_sampling.main`` over the process group:
    data-parallel, with mining, and at ``--tp_size 2``."""
    from denseretrievaltoolkits_torch import run_random_sampling

    dev, corpus, spec, mine_inputs = eval_setup(work, shard_hosts=True)
    out = {"window": np.asarray(corpus._indices()),
           "metrics": np.array(json.dumps(run_evaluations(work, "mesh", mesh, dev, corpus,
                                                         spec, mine_inputs)))}
    for label, extra in (("entry", []), ("entry_mine", MINE_ARGV), ("entry_tp", TP_ENTRY_ARGV)):
        root = os.path.join(work, label)
        run_random_sampling.main(spec["entry_argv"] + extra
                                 + ["--output_dir", os.path.join(root, "out"),
                                    "--cache_train_dir", os.path.join(root, "cache")],
                                 device="cpu")
    return out


def case_evaluate_tp(work, mesh):
    """On a dp = 2, tp = 2 mesh: ``Trainer.evaluate`` over this data rank's corpus
    window into the flat and IVF indexes, which shard over the data axis and which
    model rank 0's ranks alone save, with the miner; then ``run_random_sampling.main
    --tp_size 2`` over the 4 ranks."""
    from denseretrievaltoolkits_torch import run_random_sampling

    dev, corpus, spec, mine_inputs = eval_setup(work, shard_hosts=(mesh.size, mesh.rank))
    out = {"window": np.asarray(corpus._indices()),
           "metrics": np.array(json.dumps(run_evaluations(work, "mesh_tp", mesh, dev, corpus,
                                                         spec, mine_inputs, EVAL_CONFIGS[:2])))}
    root = os.path.join(work, "entry_dp2tp2")
    run_random_sampling.main(spec["entry_argv"] + ["--tp_size", "2"]
                             + ["--output_dir", os.path.join(root, "out"),
                                "--cache_train_dir", os.path.join(root, "cache")], device="cpu")
    return out


def flat_windows(corpus, n, mesh):
    lo, hi = host_corpus_bounds(n, mesh.size, mesh.rank)
    return corpus[lo:hi]


def case_index(work, mesh):
    """The sharded indexes over this rank's window of the test's corpora."""
    from denseretrievaltoolkits_torch.parallel.sharded_index import ShardedFlatIndex
    from denseretrievaltoolkits_torch.parallel.sharded_ivf import (CollectivePCATransform,
                                                                   load_sharded_index,
                                                                   sharded_index_factory)
    from denseretrievaltoolkits_torch.index.transforms import PCATransform

    data = np.load(os.path.join(work, "index_inputs.npz"))
    out = {}
    corpus, q = data["corpus"], data["queries"]
    n = corpus.shape[0]
    mine = flat_windows(corpus, n, mesh)
    for dtype in FLAT_DTYPES:
        for how in ("add", "add_device"):
            idx = ShardedFlatIndex(mesh, corpus.shape[1], dtype=dtype, block_size=64,
                                   device="cpu")
            if how == "add":
                idx.add(mine)
            else:  # two device slabs
                half = mine.shape[0] // 2
                idx.add_device(torch.from_numpy(mine[:half].copy()))
                idx.add_device(torch.from_numpy(mine[half:].copy()))
            idx.global_rows = n
            modes = ("exact", "serve") + (("i8q",) if dtype in ("int8", "int4") else ())
            for mode in modes:
                s, i = idx.search(q, K, mode=mode)
                out[f"flat/{dtype}/{how}/{mode}/s"], out[f"flat/{dtype}/{how}/{mode}/i"] = s, i
            if how == "add":
                idx.save(os.path.join(work, f"port_flat_{dtype}"))
        loaded = load_sharded_index(os.path.join(work, f"jax_flat_{dtype}"), mesh, device="cpu")
        s, i = loaded.search(q, K)
        out[f"flat/{dtype}/from_jax/s"], out[f"flat/{dtype}/from_jax/i"] = s, i
    # fewer rows than ranks: the last shard is empty
    tiny = data["tiny"]
    idx = ShardedFlatIndex(mesh, tiny.shape[1], device="cpu")
    idx.add(flat_windows(tiny, tiny.shape[0], mesh))
    idx.global_rows = tiny.shape[0]
    out["tiny/s"], out["tiny/i"] = idx.search(q[:, :tiny.shape[1]], K)
    idx.save(os.path.join(work, "port_tiny"))
    back = load_sharded_index(os.path.join(work, "port_tiny"), mesh, device="cpu")
    out["tiny/reloaded/i"] = back.search(q[:, :tiny.shape[1]], K)[1]
    # the trained kinds over the clustered corpus (dim 128: the PQ serve layout)
    big, bq = data["clustered"], data["clustered_queries"]
    nb = big.shape[0]
    mine = flat_windows(big, nb, mesh)
    for spec, modes in (("IVF8,SQ8", ("exact", "bulk")), ("IVFR8,Flat", ("exact", "bulk")),
                        ("PQ16", ("exact", "serve")), ("IVF8,PQ16", ("exact", "bulk")),
                        ("PCAR32,SQ8", ("exact",))):
        key = spec.replace(",", "_")
        idx = sharded_index_factory(mesh, big.shape[1], spec, nprobe=4, device="cpu")
        sample = mine[::2]
        idx.train(sample)
        idx.global_rows = nb
        idx.add_chunks(lambda s, r: torch.from_numpy(mine[s:s + r].copy()), mine.shape[0],
                       chunk_rows=97)
        for mode in modes:
            s, i = idx.search(bq, K, mode=mode)
            out[f"{key}/{mode}/s"], out[f"{key}/{mode}/i"] = s, i
        idx.save(os.path.join(work, f"port_{key}"))
        back = load_sharded_index(os.path.join(work, f"port_{key}"), mesh, device="cpu")
        out[f"{key}/reloaded/i"] = back.search(bq, K, mode=modes[-1])[1]
        from_jax = load_sharded_index(os.path.join(work, f"jax_{key}"), mesh, device="cpu")
        for mode in modes:
            s, i = from_jax.search(bq, K, mode=mode)
            out[f"{key}/from_jax/{mode}/s"], out[f"{key}/from_jax/{mode}/i"] = s, i
    # the collective PCA fit equals one process's fit on the gathered sample
    pca = CollectivePCATransform(big.shape[1], 16, rotate=True, mesh=mesh, device="cpu")
    pca.train(mine[::3])
    one = PCATransform(big.shape[1], 16, rotate=True, device="cpu")
    one.train(np.concatenate([big[a:b][::3] for a, b in (host_corpus_bounds(nb, mesh.size, r)
                                                         for r in range(mesh.size))]))
    out["pca/collective"], out["pca/one"] = pca.matrix, one.matrix
    return out


# (label, attention, optimizer, learning rate, optimizer kwargs, steps) of the tensor-parallel
# steps: adamw's and adafactor's lr keep the update of a gradient that is 0 in exact arithmetic
# (the k bias: fp32 noise, lifted to about lr by either) within the parameters' tolerance
TP_STEPS = (("xla_sgd", "xla", "sgd", 0.1, {}, 2),
            ("xla_adamw", "xla", "adamw", 2e-5, {}, 1),
            ("fused_adamw", "fused", "adamw", 2e-5, {}, 1),
            ("flash_adamw", "flash", "adamw", 2e-5, {}, 1),
            ("xla_adafactor", "xla", "adafactor", 1e-2, {}, 1),
            # factored moments over the cut axes (min_dim 16 factors every matrix here)
            ("fused_adafactor_factored", "fused", "adafactor", 1e-2,
             {"min_dim_size_to_factor": 16}, 2))


def tp_step(work, mesh, label, attention, optimizer, lr, opt_kw, steps, **model_kw):
    """``steps`` steps of ``Trainer`` on this data rank's slice of the global batch (the
    same batches as case_train); the losses and the full (gathered) parameters."""
    from denseretrievaltoolkits_torch.parallel.mesh import gathered
    from denseretrievaltoolkits_torch.train.trainer import Trainer

    tag = f"{label}{mesh.rank}.{mesh.tp_rank}"
    q, p = token_batch(8, 8, 1), token_batch(16, 12, 2)
    batch = (rank_slice(q, mesh.rank, mesh.size), rank_slice(p, mesh.rank, mesh.size))
    trainer = Trainer(train_args(work, tag, optimizer=optimizer, learning_rate=lr,
                                 optimizer_kwargs=dict(opt_kw)),
                      build_model(attention=attention, **model_kw), mesh=mesh)
    out = {f"{label}/losses": np.array([float(trainer.train_step(batch)) for _ in range(steps)])}
    with gathered(trainer.model):
        out.update(state_of(trainer.model.lm_q, label))
    return out, trainer


def case_tp(work, mesh):
    """Tensor-parallel steps on a (dp, tp) mesh: each of TP_STEPS, a LoRA step, an
    RRTrainer step and the deploy format of a tp run (``Trainer.save``)."""
    from denseretrievaltoolkits_torch.models.reranker import RRModel
    from denseretrievaltoolkits_torch.parallel.mesh import gathered
    from denseretrievaltoolkits_torch.train.trainer import RRTrainer

    out = {"mesh": np.array([mesh.size, mesh.tp, mesh.rank, mesh.tp_rank])}
    for label, attention, optimizer, lr, opt_kw, steps in TP_STEPS:
        reading, trainer = tp_step(work, mesh, label, attention, optimizer, lr, opt_kw, steps)
        out.update(reading)
        if label == "xla_sgd":  # the deploy format and this model rank's resume checkpoint
            trainer.save(1)
            out["shard_qkv"] = trainer.model.lm_q.layers[0].qkv_kernel.detach().numpy().copy()
    reading, _ = tp_step(work, mesh, "lora", "xla", "sgd", 0.5, {}, 2,
                         param_efficient_method="lora", lora_rank=4)
    out.update(reading)
    margs = ModelArguments(model_name_or_path=os.path.join(work, "rr_arch"), pooling="first",
                           pos_token="yes", neg_token="no")
    rargs = RRTrainingArguments(output_dir=os.path.join(work, f"rr{mesh.rank}.{mesh.tp_rank}"),
                                cache_train_dir=os.path.join(work, "rrc"), loss_fn="mr",
                                margin=0.7, optimizer="sgd", learning_rate=1e-2, log_every=0,
                                save_per_train=10)
    rr = RRModel.build(margs, train_args=rargs, tokenizer=RRTok(), device="cpu", seed=3)
    rtrainer = RRTrainer(rargs, rr, mesh=mesh)
    r, w = mesh.rank, mesh.size
    pairs = [(token_batch(8, 12, 10 + i), token_batch(8, 12, 20 + i)) for i in range(2)]
    out["rr_losses"] = np.array([float(rtrainer.train_step((rank_slice(a, r, w),
                                                             rank_slice(b, r, w))))
                                 for a, b in pairs])
    with gathered(rr):
        out.update(state_of(rr.lm, "rr"))
    return out


CASES = {"train": case_train, "evaluate": case_evaluate, "index": case_index}


def main(argv):
    case, rank, world, port, work = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    maybe_initialize_distributed("gloo", device="cpu", timeout_s=120)
    if case.startswith("tp"):  # "tp<dp>x<tp>": the tensor-parallel steps on a dp x tp mesh
        dp, tp = map(int, case[2:].split("x"))
        out = case_tp(work, make_mesh(dp, tp))
    elif case == "evaluate_tp":
        out = case_evaluate_tp(work, make_mesh(2, 2))
    else:
        out = CASES[case](work, make_mesh())
    np.savez(os.path.join(work, f"{case}.rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

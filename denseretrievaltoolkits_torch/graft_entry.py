"""Entry points: a one-card forward check and a multi-process dry run.

The port's twin of the JAX package's root ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, example_args)``: ``fn(model, query, passage)``
  is the flagship model's forward step, the BERT-base dual encoder (bf16,
  ``attention='fused'``: K1 / K2) computing the in-batch contrastive loss and
  the scores, on the card unless ``device`` names another;
- :func:`dryrun_multichip` runs ONE training step and the sharded searches
  (flat fp32, int8 in exact / serve / i8q, int4 i8q, ``IVFR8,SQ8`` i8q, ``PQ8``
  and ``IVF8,PQ64x4`` approx) over ``n`` worker processes, ``gloo`` ranks that
  share one card (or the CPU), at 128 dimensions (the JAX dry run's IVF-PQ
  leg's; its other searches take 32, under the card's int8-query bodies' H %
  128). As the JAX dry run (:140-142 there) the mesh is ``tp = 2`` for even
  ``n``, ``dp = n / tp``: the step cuts the BERT layers over the model axis
  (``parallel/mesh.py``) and the indexes shard over the data axis.

Run the dry run alone as ``python -m denseretrievaltoolkits_torch.graft_entry [n]
[tiny|bert-base] [device]``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_TIMEOUT_S = 600
DIM = 128  # the dry run's searches (the JAX one's flat, IVF and PQ legs take 32)


def _tiny_config(vocab=512):
    from .models.bert import BertConfig

    return BertConfig(vocab_size=vocab, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128, max_position_embeddings=64)


def _batch(rng, n, seq, vocab):
    return {"input_ids": rng.integers(1, vocab, size=(n, seq)).astype(np.int32),
            "attention_mask": np.ones((n, seq), np.int32)}


def build_model(config, dtype: str = "bfloat16", attention: str = "xla", device=None,
                seed: int = 0):
    """The tied dual encoder of ``config`` with seeded random weights
    (``init_params_numpy``)."""
    from .models.biencoder import DRModel, DRModelSpec
    from .models.convert import init_params_numpy

    model = DRModel(DRModelSpec(bert_config=config, dtype=dtype, attention=attention),
                    device=device)
    model.load_tower_tree("lm_q", init_params_numpy(config, seed))
    return model


def entry(config=None, dtype: str = "bfloat16", attention: str = "fused", device=None):
    """(fn, example_args): the forward step on the flagship model, the BERT-base
    dual encoder computing the in-batch contrastive loss (``config`` and
    ``dtype`` select another, as the tests do on the CPU). ``fn(model, query,
    passage)`` returns (loss, scores); the batches are the JAX entry's draws
    (8 x 32 queries, 16 x 128 passages, ``default_rng(0)``)."""
    from .models.bert import BertConfig

    config = config or BertConfig()  # bert-base shape
    model = build_model(config, dtype=dtype, attention=attention, device=device)
    rng = np.random.default_rng(0)
    query = _batch(rng, 8, 32, config.vocab_size)
    passage = _batch(rng, 16, 128, config.vocab_size)

    def fn(model, query, passage):
        out = model(query=query, passage=passage)
        return out["loss"], out["scores"]

    return fn, (model, query, passage)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, size: str = None, device=None) -> dict:
    """ONE training step over an ``n_devices``-rank mesh (``tp = 2`` for even
    ``n_devices``) and the sharded-index searches, in ``n_devices`` worker processes (gloo on
    ``127.0.0.1``). ``size`` (or env ``GRAFT_DRYRUN_SIZE``): "tiny" (default) or
    "bert-base"; ``device``: the card all ranks share (``cuda:0``) unless named.
    Raises if a rank fails or the ranks disagree; returns rank 0's readings."""
    size = size or os.environ.get("GRAFT_DRYRUN_SIZE", "tiny")
    if size not in ("tiny", "bert-base"):
        raise ValueError(f"size must be 'tiny' or 'bert-base', got {size!r}")
    from .device import resolve_device

    device = str(resolve_device(device or "cuda:0", "dryrun_multichip"))
    port = str(_free_port())
    with tempfile.TemporaryDirectory() as work:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "denseretrievaltoolkits_torch.graft_entry", "--rank", str(r),
             str(n_devices), port, size, device, work], cwd=_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError(f"dryrun_multichip: a rank ran past {DRYRUN_TIMEOUT_S} s")
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"dryrun_multichip: ranks {failed} failed:\n"
                               + "\n".join(logs[r][-4000:] for r in failed))
        readings = []
        for r in range(n_devices):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                readings.append(json.load(fh))
    if any(r != readings[0] for r in readings[1:]):
        raise RuntimeError("dryrun_multichip: the ranks' losses or search results differ")
    out = readings[0]
    print(f"dryrun_multichip OK: mesh {out['mesh']}, loss {out['loss']:.4f}, quantized sharded "
          f"search modes exact/serve/i8q (int8 + packed int4) + sharded IVF i8q + sharded PQ "
          f"+ sharded IVF-PQ x4", flush=True)
    return out


def _dryrun_rank(rank: int, world: int, port: str, size: str, device: str, work: str) -> None:
    """One rank of :func:`dryrun_multichip`: writes ``rank<r>.json`` under ``work``."""
    import torch

    from .config import TrainingArguments
    from .models.bert import BertConfig
    from .parallel.mesh import make_mesh
    from .parallel.sharded_index import ShardedFlatIndex
    from .parallel.sharded_ivf import sharded_index_factory
    from .train.trainer import Trainer
    from .utils.distributed import host_corpus_bounds, maybe_initialize_distributed

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if device == "cpu":
        torch.set_num_threads(1)
    maybe_initialize_distributed("gloo", device=device, timeout_s=DRYRUN_TIMEOUT_S)
    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world // tp, tp)
    dp, data_rank = mesh.size, mesh.rank

    config = BertConfig() if size == "bert-base" else _tiny_config()
    model = build_model(config, device=device)
    args = TrainingArguments(output_dir=os.path.join(work, f"out{rank}"),
                             cache_train_dir=os.path.join(work, f"cache{rank}"),
                             learning_rate=1e-4, optimizer="adamw", log_every=0)
    trainer = Trainer(args, model, mesh=mesh)
    rng = np.random.default_rng(0)
    query, passage = (_batch(rng, 2 * dp, 16, config.vocab_size),
                      _batch(rng, 4 * dp, 24, config.vocab_size))

    def mine(batch):  # this data rank's slice of the global batch
        n = batch["input_ids"].shape[0] // dp
        return {k: v[data_rank * n:(data_rank + 1) * n] for k, v in batch.items()}

    loss = float(trainer.train_step((mine(query), mine(passage))))
    assert np.isfinite(loss), f"non-finite loss {loss}"
    out = {"mesh": dict(mesh.shape), "loss": loss, "searches": {}}

    def searched(name, index, q, n_rows, mode=None):
        kw = {} if mode is None else {"mode": mode}
        _, ids = index.search(q, 10, **kw)
        ids = np.asarray(ids.cpu() if hasattr(ids, "cpu") else ids)
        assert ids.shape == (4, 10) and ids.max() < n_rows, (name, ids.shape)
        out["searches"][name] = ids.tolist()

    def window(rows):
        lo, hi = host_corpus_bounds(rows.shape[0], dp, data_rank)
        return rows[lo:hi]

    # sharded flat-index search over the data axis (per-shard top-k + merge); 128 dims
    # where the JAX dry run takes 32: the card's int8-query bodies take H % 128 == 0
    corpus = rng.normal(size=(64 * dp + 7, DIM)).astype(np.float32)
    q = rng.normal(size=(4, DIM)).astype(np.float32)
    n = corpus.shape[0]
    for dtype, modes in (("float32", (None,)), ("int8", ("exact", "serve", "i8q")),
                         ("int4", ("i8q",))):  # int4: nibble-packed rows
        index = ShardedFlatIndex(mesh, dim=DIM, block_size=64, dtype=dtype, device=device)
        index.global_rows = n
        index.add(window(corpus))
        for mode in modes:
            searched(f"{dtype}/{mode or 'exact'}", index, q, n, mode)
    # the trained factory kinds on the mesh: ragged IVF, PQ, IVF-PQ
    corpus_ivfpq = rng.normal(size=(48 * dp + 5, DIM)).astype(np.float32)
    q_ivfpq = rng.normal(size=(4, DIM)).astype(np.float32)
    for spec, rows, qs, mode, kw in (("IVFR8,SQ8", corpus, q, "i8q", {}),
                                     ("PQ8", corpus, q, "approx", {"iters": 3}),
                                     ("IVF8,PQ64x4", corpus_ivfpq, q_ivfpq, "approx", {"iters": 3})):
        index = sharded_index_factory(mesh, rows.shape[1], spec, nprobe=4, device=device)
        index.train(window(rows), **kw)
        index.global_rows = rows.shape[0]
        index.add(window(rows))
        searched(spec, index, qs, rows.shape[0], mode)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--rank"]:
        _dryrun_rank(int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5], argv[6])
        return 0
    dryrun_multichip(int(argv[0]) if argv else 2, *argv[1:3])
    return 0


if __name__ == "__main__":
    sys.exit(main())

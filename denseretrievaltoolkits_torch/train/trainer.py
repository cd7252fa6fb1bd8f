"""Dense-retriever training loop and retrieval evaluation.

Counterpart of ``Trainer`` in ``denseretrievaltoolkits_tpu/train/trainer.py``
(:42-697): warmup derived from ``warmup_ratio``, one optimizer update per
``train_step`` (the full batch, or chunked with ``grad_cache``), the epoch
loop with the shared ``prefetch``, a log line and ``train_log.jsonl`` at the
log cadence, a ``torch.profiler`` trace of step 2
when ``profile_dir`` is set, the stop on a non-finite epoch loss, the save
cadence (the deploy format under ``cache_train_dir/result{N}`` and a resume
checkpoint, ``torch.save`` of params, optimizer state, epoch and step, under
``output_dir/checkpoint/ep{N}``, in place of Orbax), and the evaluation
cadences: ``eval_loader`` every ``eval_per_train`` epochs, ``test_loader``
once at the end (as epoch -1).

Evaluation (trainer.py:290-594 there) encodes the corpus loader's passages
on the model's device into a :class:`FlatIPIndex` at ``index_dtype`` through
``add_device`` in slabs of ``index_slab_rows`` (int8 / int4 slabs quantize on
the card, K7 / K9), or into an ``index_factory`` index: a trained one (IVF,
IVFR, PQ, IVF-PQ, PCA / PCAR / OPQ chains) cannot take rows before it is fit, so the encoded
batches stream to the ``{encode_corpus_dir}/{ep}.0.npy`` memmap instead, the
index trains on a strided sample of at most ``index_train_rows`` of them and
is built by ``add_chunks`` in ``index_slab_rows`` chunks (the memmap is
removed after unless ``save_corpus_artifacts``). It then saves the index and
its docid order, searches each query batch in ``search_mode`` (flat: K5/K6/K10
exact, K8/K11 serve, K12 i8q; IVF: K13/K14 bulk, i8q, probe; PQ: K16 / K15
serve, exact ADC; IVF-PQ: K17 bulk), labels the hits with
``evaluator/nq_eval.py``'s ``AnswerMatcher`` (or docid relevance with
``label_kind="docids"``) and writes the retrieval dump
``{retrieve_dir}/{ep}.0.json`` and the metrics ``{cache_train_dir}/{ep}.0_metrics``.
Corpus texts are read as ``dataset[rows]["original"]``, row by row where the
dataset has no fancy indexing (a plain list of dicts).

A ``miner`` (``mine/miner.py:DenseMiner``) refreshes the train set's negatives
every ``mine_per_train`` epochs, after the evaluation, from the index of that
epoch's weights (re-encoded when stale), as the reference does
(trainer.py:239-252). The model holds its parameters, so there is no
``params`` argument; with LoRA adapters only they and the heads train
(``optimizers.get_optimizer``).

A ``mesh`` (``parallel/mesh.py``: one rank a card, trainer.py:85-170 there)
makes the trainer data-parallel: rank 0's parameters are broadcast at start;
each rank steps on its slice of the global batch (the loaders' strided,
equal-length shards), the contrastive loss covers every rank's reps
(``negatives_x_device``, else each rank's own block and the mean over ranks),
and the averaged gradient is the full batch's, so the ranks' parameters stay
equal. The evaluation encodes this rank's ``host_corpus_bounds`` window of
the corpus (``CorpusDataloader(shard_hosts=True)``) into a sharded index
(``parallel/``), searches it with replicated queries, and returns the same
metrics on every rank; rank 0 alone writes the dumps, the metrics, the
deploy format and the checkpoints.

A mesh with a model axis (``tp_size`` > 1) also cuts the BERT layers over it
(``parallel/mesh.py:shard_module``, as ``shard_state`` there) before the
optimizer is made, so each rank's optimizer state covers its parts. The ranks
of a model group step on the same rows; gradients are averaged over the data
group. ``save`` gathers the parts into the deploy format (one process, or the
JAX package through ``params_to_jax``, loads it); the resume checkpoint keeps
each model rank's parts (``state.tp{m}.pt``). In the evaluation the model ranks
of a data rank encode the same window, each into its data group's index, and
model rank 0's group alone writes the encoded corpus and the index.

``RRTrainer`` (trainer.py:699-796 there) trains a ``models.reranker.RRModel`` on
(pos_pairs, neg_pairs) batches and evaluates it over the dense retriever's
top-k pairs: the rerank dump ``{rr_result_dir}/{ep}.0.json`` and the metrics
``{cache_train_dir}/{ep}.0_RR_metrics``.

Resume differs from the reference on purpose. The reference saves ``ep + 1``
(the epochs done) and ``load`` starts at ``epoch + 1``, so a resumed run skips
an epoch (trainer.py:235-236, 695). Here ``load`` starts at the first epoch
not completed, so a resumed run repeats the uninterrupted run's steps.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.loaders import prefetch
from ..evaluator.metrics import get_metrics
from ..evaluator.nq_eval import AnswerMatcher
from ..index.flat import FlatIPIndex
from ..parallel.mesh import (all_reduce_grads, data_parallel_backward, rank_zero,
                             shard_module)
from .grad_cache import grad_cache_backward
from .optimizers import get_optimizer

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = "state.pt"


def _dataset_ids(dataset) -> List:
    """The ``id`` column of a corpus dataset (HF datasets or a list of dicts)."""
    try:
        return list(dataset["id"])
    except (TypeError, KeyError, IndexError):
        return [row["id"] for row in dataset]


class Trainer:
    """Trains a ``models.biencoder.DRModel`` in place."""

    def __init__(self, training_args, model, corpus_dataloader=None, train_loader=None,
                 eval_loader=None, test_loader=None, mesh=None, label_kind: str = "answers",
                 miner=None):
        self.training_args = training_args
        self.model = model
        self.corpus_dataloader = corpus_dataloader
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.test_loader = test_loader
        self.label_kind = label_kind  # "answers" (NQ-style) | "docids" (relevancy)
        self.miner = miner  # mine/miner.py DenseMiner, run at the mine_per_train cadence
        self.mesh = mesh  # parallel/mesh.py Mesh: data (and tensor) parallel over its ranks
        if mesh is not None:
            mesh.broadcast_module(model)
            shard_module(model, mesh)  # before the optimizer: its state takes the parts
        self.topk = training_args.topk_list
        self.start_epoch = 0
        self.idx: List = []  # docid order of the corpus index
        self.index = None  # FlatIPIndex, or an index_factory index
        self._indexed_ep = None
        self._row2ds = None
        self._matcher = AnswerMatcher()  # memoized tokenization, renewed per evaluate
        # warmup_ratio: with a schedule but no explicit warmup/max steps, derive
        # them from the training horizon (trainer.py:74-83)
        if training_args.scheduler and train_loader is not None:
            try:
                total = max(1, len(train_loader) * training_args.max_epochs)
                kw = training_args.scheduler_kwargs
                kw.setdefault("n_warmup_steps", max(1, int(training_args.warmup_ratio * total)))
                if training_args.scheduler in ("linear", "cosine"):
                    kw.setdefault("max_steps", total)
            except TypeError:
                pass  # loader without __len__: schedule kwargs must be explicit
        self.optimizer = get_optimizer(training_args, model)
        self.step = 0

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer update on a (query, passage) batch: the full batch
        through autograd, or with ``grad_cache`` the chunked step of
        ``train/grad_cache.py`` (``gc_q_chunk_size`` / ``gc_p_chunk_size`` rows a
        chunk; trainer.py:136-146). Returns the loss as a device tensor: no
        per-step host sync (trainer.py:177-187)."""
        args = self.training_args
        self.model.train()
        if args.grad_cache:
            self.optimizer.zero_grad()
            loss = grad_cache_backward(self.model, batch[0], batch[1], args.gc_q_chunk_size,
                                       args.gc_p_chunk_size, mesh=self.mesh)
            if self.mesh is not None:  # each rank's rows carry their true share: sum them
                all_reduce_grads(self.model.parameters(), self.mesh, mean=False)
        elif self.mesh is not None:
            self.optimizer.zero_grad()
            loss = data_parallel_backward(self.model, batch[0], batch[1], self.mesh,
                                          getattr(args, "negatives_x_device", True))
        else:
            loss = self.model.forward(batch[0], batch[1])["loss"]
            self.optimizer.zero_grad()
            loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def train(self) -> None:
        """Epoch loop with the log, save, evaluation and mining cadences, then the
        test evaluation (trainer.py:191-254)."""
        args = self.training_args
        for ep in range(self.start_epoch, args.max_epochs):
            self.train_loader.set_epoch(ep)
            t0 = time.time()
            losses = []
            for step_idx, batch in enumerate(prefetch(self.train_loader)):
                if args.profile_dir and ep == self.start_epoch and step_idx == 2:
                    losses.append(self._profiled_step(batch, args.profile_dir))
                    continue
                loss = self.train_step(batch)
                losses.append(loss)
                if args.log_every and (step_idx + 1) % args.log_every == 0:
                    loss_f = float(loss)  # the one sync, at the log cadence
                    s_per_step = (time.time() - t0) / (step_idx + 1)
                    logger.info("epoch %d step %d loss %.4f (%.2f s/step)",
                                ep + 1, step_idx + 1, loss_f, s_per_step)
                    self._log_metrics({"epoch": ep + 1, "step": self.step, "loss": loss_f,
                                       "s_per_step": s_per_step})
            mean_loss = float(torch.stack(losses).float().mean())
            if not math.isfinite(mean_loss):
                raise FloatingPointError(
                    f"non-finite mean loss {mean_loss} at epoch {ep + 1}; "
                    f"resume from the last checkpoint under "
                    f"{args.output_dir}/checkpoint with --resume_from "
                    f"(consider a lower learning_rate or --remat full)")
            logger.info("epoch %d done, mean loss %.4f", ep + 1, mean_loss)
            self._log_metrics({"epoch": ep + 1, "step": self.step, "mean_loss": mean_loss,
                               "epoch_seconds": time.time() - t0})
            if (ep + 1) % args.save_per_train == 0:
                self.save(ep + 1)
            if self.eval_loader is not None and (ep + 1) % args.eval_per_train == 0:
                self.evaluate(self.eval_loader, ep + 1)
            if (self.miner is not None and getattr(args, "mine_per_train", 0)
                    and (ep + 1) % args.mine_per_train == 0
                    and self.corpus_dataloader is not None):
                # the refresh (trainer.py:239-252 there): the index of this epoch's
                # weights (re-encoded when stale), then the mined rows train from here
                if self._indexed_ep != ep + 1:
                    self._encoding_corpus(ep + 1)
                    self._indexed_ep = ep + 1
                self.train_loader.dataset = self.miner.mine(list(self.train_loader.dataset))
        if self.test_loader is not None:
            self.evaluate(self.test_loader, -1)

    def _profiled_step(self, batch, profile_dir: str) -> torch.Tensor:
        """One step under ``torch.profiler``; the trace goes to
        ``profile_dir/train_step.json`` (Chrome trace format)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            loss = self.train_step(batch)
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "train_step.json"))
        return loss

    def _log_metrics(self, record: Dict[str, Any]) -> None:
        """Append a record to ``{output_dir}/train_log.jsonl`` (rank 0's)."""
        if not rank_zero(self.mesh):
            return
        try:
            os.makedirs(self.training_args.output_dir, exist_ok=True)
            path = os.path.join(self.training_args.output_dir, "train_log.jsonl")
            with open(path, "a", encoding="utf-8") as fh:
                json.dump({"time": time.time(), **record}, fh)
                fh.write("\n")
        except OSError:  # logging must never kill training
            logger.debug("could not write train_log.jsonl", exc_info=True)

    # -- retrieval evaluation -------------------------------------------------

    def _sharded(self) -> bool:
        """The corpus index is split over several ranks."""
        return self.mesh is not None and self.mesh.size > 1

    def _make_index(self, dim: int):
        """A flat index on the model's device at ``index_dtype``, or the
        ``index_factory`` string's, probing ``nprobe`` cells (trainer.py:290-323)."""
        args = self.training_args
        factory = getattr(args, "index_factory", "")
        if self._sharded():
            from ..parallel.sharded_index import ShardedFlatIndex
            from ..parallel.sharded_ivf import sharded_index_factory

            if factory:
                return sharded_index_factory(self.mesh, dim, factory,
                                             nprobe=getattr(args, "nprobe", 32),
                                             device=self.model.device)
            return ShardedFlatIndex(self.mesh, dim, dtype=args.index_dtype,
                                    device=self.model.device)
        if factory:
            from ..index.flat import index_factory

            return index_factory(dim, factory, nprobe=getattr(args, "nprobe", 32),
                                 device=self.model.device)
        return FlatIPIndex(dim, dtype=args.index_dtype, device=self.model.device)

    def _encoding_corpus(self, ep: int) -> None:
        """Encode the corpus into the device-resident index (trainer.py:325-428):
        encoded batches stay on the device and flush into ``add_device`` in
        slabs of ``index_slab_rows``, so int8 / int4 rows quantize on the card
        and the float reps are freed. With ``save_corpus_artifacts`` the reps
        also stream to ``{encode_corpus_dir}/{ep}.0.npy`` (a memmap) and the
        docids to ``{ep}.0.json``. An index that is not trained yet takes no
        rows: the reps go to the memmap only (made whatever
        ``save_corpus_artifacts`` says, removed after unless it is set), and
        :meth:`_build_trained_index` fits and fills the index from there. On a
        mesh each rank encodes its own window (``{ep}.{rank}.npy``), the index
        learns the corpus size before it is built, and the docid order is the
        dataset's (trainer.py:402-418 there)."""
        args = self.training_args
        loader = self.corpus_dataloader
        slab_rows = max(loader.batch_size, getattr(args, "index_slab_rows", 262144))
        save = getattr(args, "save_corpus_artifacts", True)
        ids: List = []
        self.index = None
        buf: List[torch.Tensor] = []
        buf_rows = 0
        mmap = None
        spill = False  # a trained factory index: rows go to the memmap, not the device
        row = 0
        rank = 0 if self.mesh is None else self.mesh.rank
        mmap_path = os.path.join(args.encode_corpus_dir, f"{ep}.{rank}.npy")
        if not self._writes_index():  # a model rank > 0 spills to its own file, then drops it
            save = False
            mmap_path = mmap_path[:-len(".npy")] + f".tp{self.mesh.tp_rank}.npy"

        def flush():
            nonlocal buf, buf_rows
            if buf:
                self.index.add_device(buf[0] if len(buf) == 1 else torch.cat(buf))
                buf, buf_rows = [], 0

        self.model.eval()
        for batch_ids, batch in prefetch(loader):
            out = self.model.encode_passage(batch)  # under inference mode, on the device
            valid = int(out.shape[0])
            if self.index is None:
                self.index = self._make_index(int(out.shape[1]))
                spill = not getattr(self.index, "is_trained", True)
            if save or spill:
                if mmap is None:
                    os.makedirs(args.encode_corpus_dir, exist_ok=True)
                    mmap = np.lib.format.open_memmap(
                        mmap_path, mode="w+", dtype=np.float32,
                        shape=(len(loader._indices()), int(out.shape[1])))
                mmap[row:row + valid] = out.float().cpu().numpy()
            if not spill:
                buf.append(out)
                buf_rows += valid
                if buf_rows >= slab_rows:
                    flush()
            row += valid
            ids.extend(batch_ids)
        flush()
        if self._sharded():
            self.index.global_rows = len(loader.dataset)
        if mmap is not None:
            mmap.flush()
            if spill:
                self._build_trained_index(mmap, row, slab_rows)
            del mmap
            if spill and not save:
                os.remove(mmap_path)
        self.idx = _dataset_ids(loader.dataset) if self._sharded() else ids
        self.index.docid = self.idx
        # a length-sorted encode iterates out of dataset order: index row r
        # holds dataset row perm[r] (docids already follow the iteration)
        self._row2ds = (np.asarray(loader._indices())
                        if getattr(loader, "length_sorted", False) else None)
        if save:
            with open(os.path.join(args.encode_corpus_dir, f"{ep}.{rank}.json"), "w",
                      encoding="utf-8") as fh:
                json.dump({"id": ids}, fh, ensure_ascii=False)

    def _build_trained_index(self, mmap, n_rows: int, chunk_rows: int) -> None:
        """Fit the index on a strided sample of the encoded corpus (at most
        ``index_train_rows`` rows; the reference trains faiss on what fits,
        index.py:52), then build it through ``add_chunks`` a chunk of the
        memmap at a time (trainer.py:430-453), so the device holds the index
        and one chunk, never the encoded corpus."""
        n_rows = int(n_rows)
        n_train = max(1, min(n_rows, getattr(self.training_args, "index_train_rows", 262144)))
        step = max(1, n_rows // n_train)
        self.index.train(np.ascontiguousarray(mmap[::step][:n_train]))
        self.index.add_chunks(lambda s, r: torch.from_numpy(np.asarray(mmap[s:s + r])), n_rows,
                              chunk_rows=int(max(1, min(n_rows, chunk_rows))))

    def _writes_index(self) -> bool:
        """This rank's data group writes the encoded corpus and the index: model
        rank 0's (every group holds the same)."""
        return self.mesh is None or self.mesh.tp_rank == 0

    def _index_corpus(self, ep: int) -> None:
        """Save the index (collective on a mesh's data group) and, from rank 0, its
        docid order (trainer.py:455-468)."""
        args = self.training_args
        if not getattr(args, "save_corpus_artifacts", True) or not self._writes_index():
            return
        self.index.save(args.index_file + str(ep))
        if not rank_zero(self.mesh):
            return
        order = {"id": self.idx}
        if self._row2ds is not None:
            order["perm"] = np.asarray(self._row2ds).tolist()
        with open(os.path.join(args.index_order_dir, f"{ep}.docid.txt"), "w",
                  encoding="utf-8") as fh:
            json.dump(order, fh, ensure_ascii=False)

    def _load_index(self, ep: int) -> None:
        """Restore a saved index and its docid order onto the model's device
        (trainer.py:470-494)."""
        args = self.training_args
        if self._sharded():
            from ..parallel.sharded_ivf import load_sharded_index

            self.index = load_sharded_index(args.index_file + str(ep), self.mesh,
                                            device=self.model.device)
        else:
            from ..index.io import load_index

            self.index = load_index(args.index_file + str(ep), device=self.model.device)
        with open(os.path.join(args.index_order_dir, f"{ep}.docid.txt"),
                  encoding="utf-8") as fh:
            order = json.load(fh)
        self.idx = order["id"]
        self._row2ds = np.asarray(order["perm"], dtype=np.int64) if "perm" in order else None

    def _label_hit(self, doc_text: str, doc_id, answers) -> bool:
        if self.label_kind == "docids":
            return doc_id in answers
        return self._matcher.match(doc_id, doc_text, answers)

    def _texts(self, corpus_ds, rows) -> Dict[int, str]:
        """``original`` texts of index rows ``rows``: one fancy-indexed read (HF
        datasets), else row by row."""
        ds_rows = [int(self._row2ds[r]) for r in rows] if self._row2ds is not None else rows
        try:
            return dict(zip(rows, corpus_ds[ds_rows]["original"]))
        except (TypeError, KeyError):
            return {r: corpus_ds[d]["original"] for r, d in zip(rows, ds_rows)}

    def evaluate(self, query_loader, ep: int) -> Dict[str, float]:
        """Retrieval evaluation (trainer.py:505-594): corpus encode and index
        (once per ``ep``), per-batch query encode and top-k search in
        ``search_mode``, answer labeling, running metric sums, the retrieval
        dump and the metrics json. A -1 row (fewer finite candidates than k)
        counts as a miss and is not dumped."""
        args = self.training_args
        if self.index is None or ep != self._indexed_ep:
            self._encoding_corpus(ep)
            self._index_corpus(ep)
            self._indexed_ep = ep
        corpus_ds = getattr(self.corpus_dataloader, "dataset", None)
        self._matcher = AnswerMatcher()
        m_all = {f"{m}@{k}": 0.0 for m in ("MRR", "NDCG", "Recall") for k in self.topk}
        eval_num = 0
        search_mode = getattr(args, "search_mode", "exact")
        self.model.eval()
        os.makedirs(args.retrieve_dir, exist_ok=True)
        # queries are replicated over the ranks: rank 0 writes for all (trainer.py:530)
        with open(os.path.join(args.retrieve_dir, f"{ep}.0.json") if rank_zero(self.mesh)
                  else os.devnull, "w", encoding="utf-8") as dump_fh:
            for qids, batch, answers, originals in query_loader:
                q_reps = self.model.encode_query(batch)
                valid = int(q_reps.shape[0])
                k = min(args.retrieve_num, len(self.index))
                scores, indices = self.index.search(q_reps, k, mode=search_mode)
                texts = {}
                if corpus_ds is not None:
                    texts = self._texts(corpus_ds, sorted({int(r) for r in indices.ravel()
                                                           if r >= 0}))
                pos_index = np.zeros((valid, k), dtype=np.int8)
                for i in range(valid):
                    eval_num += 1
                    for j, row in enumerate(indices[i]):
                        if row < 0:
                            continue
                        docid = self.idx[row]
                        doc_text = texts.get(int(row), "")
                        if self._label_hit(doc_text, docid, answers[i]):
                            pos_index[i][j] = 1
                        json.dump({"doc_id": docid, "query_id": qids[i], "query": originals[i],
                                   "document": doc_text, "answers": list(answers[i]),
                                   "score": float(scores[i][j])}, dump_fh, ensure_ascii=False)
                        dump_fh.write("\n")
                batch_metrics = get_metrics(pos_index, self.topk)
                for key in m_all:
                    m_all[key] += batch_metrics[key]
        dp = max(2, getattr(args, "decimal_place", 4))
        for key in m_all:
            m_all[key] = m_all[key] / max(eval_num, 1)
            logger.info("%s %.*f", key, dp, m_all[key])
        m_all["query_num"] = eval_num
        if rank_zero(self.mesh):
            with open(os.path.join(args.cache_train_dir, f"{ep}.0_metrics"), "w",
                      encoding="utf-8") as fh:
                json.dump(m_all, fh, ensure_ascii=False)
        return m_all

    # -- persistence ---------------------------------------------------------

    def save(self, i_epoch: int) -> None:
        """Deploy format under ``cache_train_dir/result{N}`` (the layout the
        JAX package and ``DRModelForInference.build`` load) and the resume
        checkpoint under ``output_dir/checkpoint/ep{N}``; on a mesh rank 0
        writes them (every rank holds the same parameters) and the ranks meet
        after. With a model axis every rank joins the deploy format's gather
        (``model.save``), and data rank 0 of each model rank writes its parts'
        checkpoint."""
        args = self.training_args
        tp = self.mesh is not None and self.mesh.tp > 1
        if rank_zero(self.mesh) or tp:
            self.model.save(os.path.join(args.cache_train_dir, f"result{i_epoch}"))
        if self.mesh is None or self.mesh.rank == 0:
            self.save_checkpoint(os.path.join(args.output_dir, "checkpoint"), i_epoch)
        if self.mesh is not None and self.mesh.live:
            torch.distributed.barrier()  # every rank of the world: each model rank wrote

    def _checkpoint_file(self) -> str:
        if self.mesh is None or self.mesh.tp == 1:
            return CHECKPOINT_FILE
        return CHECKPOINT_FILE.replace(".pt", f".tp{self.mesh.tp_rank}.pt")

    def save_checkpoint(self, path: str, epoch: int) -> None:
        """``path/ep{epoch}/state.pt`` (``state.tp{m}.pt``, this model rank's parts,
        under a model axis): params, optimizer state (with its update count), and
        ``epoch`` (epochs completed) and ``step``."""
        ckpt_dir = os.path.join(os.path.abspath(path), f"ep{epoch}")
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                   "meta": {"epoch": epoch, "step": self.step}}
        tmp = os.path.join(ckpt_dir, self._checkpoint_file() + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(ckpt_dir, self._checkpoint_file()))

    def load(self, filename: str, ckpt_type=None) -> None:
        """Resume params, optimizer state and step from a checkpoint dir.
        Training restarts at the first epoch the checkpoint did not complete
        (``ckpt_type`` given: at epoch 0, as the reference)."""
        # on the host: the optimizer moves its state to each parameter's device,
        # and keeps the update counts on the host as torch.optim wants them
        payload = torch.load(os.path.join(filename, self._checkpoint_file()), map_location="cpu",
                             weights_only=True)
        self.model.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.start_epoch = int(payload["meta"]["epoch"]) if ckpt_type is None else 0
        self.step = int(payload["meta"]["step"])


class RRTrainer(Trainer):
    """Cross-encoder reranker trainer (JAX ``RRTrainer``, trainer.py:699-796): trains a
    ``models.reranker.RRModel`` in place on (pos_pairs, neg_pairs) batches and
    evaluates it over the dense retriever's top-k pairs."""

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer update on a (pos_pairs, neg_pairs) batch; the loss as a device
        tensor. On a mesh each rank's pairs are its slice of the global batch: the
        gradients and the loss are averaged over the ranks, the mean over every pair
        (trainer.py:715-741 there)."""
        self.model.train()
        loss = self.model(batch[0], batch[1])["loss"]
        self.optimizer.zero_grad()
        loss.backward()
        if self.mesh is not None:
            all_reduce_grads(self.model.parameters(), self.mesh, mean=True)
            loss = self.mesh.mean(loss)
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def evaluate(self, pair_loader, ep: int) -> Dict[str, float]:
        """Score each (q, d) pair, group by qid, sort, compute metrics (trainer.py:754-796):
        the relevance is the last score (``[1]`` heads and ``[neg, pos]`` logits alike);
        each pair is labeled by ``AnswerMatcher`` and dumped to
        ``{rr_result_dir}/{ep}.0.json`` inside the batch loop, so document text never
        accumulates; the metrics go to ``{cache_train_dir}/{ep}.0_RR_metrics``. The
        reference pads each batch to the loader's size for XLA's static shapes; here
        each batch is scored as it comes, with the same rows and metrics. On a mesh the
        pairs are replicated: every rank scores them all and returns the same metrics,
        and rank 0 writes the files (trainer.py:754-796)."""
        args = self.training_args
        result: Dict[Any, tuple] = {}
        matcher = AnswerMatcher()
        self.model.eval()
        os.makedirs(args.rr_result_dir, exist_ok=True)
        with open(os.path.join(args.rr_result_dir, f"{ep}.0.json") if rank_zero(self.mesh)
                  else os.devnull, "w", encoding="utf-8") as fh:
            for qids, batch, answers, docs, dids in pair_loader:
                scores = self.model.score(batch).float().cpu().numpy()
                for q, a, d, s, did in zip(qids, answers, docs, scores, dids):
                    bucket = result.setdefault(q, ([], []))
                    score = float(s[-1])
                    match = int(matcher.match(did, d, a))
                    bucket[0].append(score)
                    bucket[1].append(match)
                    json.dump({"qid": q, "did": did, "score": score, "match": match,
                               "document": d}, fh, ensure_ascii=False)
                    fh.write("\n")
        m_all = {f"{m}@{k}": 0.0 for m in ("MRR", "NDCG", "Recall") for k in self.topk}
        eval_num = 0
        for qid, (scores, is_true) in result.items():
            eval_num += 1
            order = np.argsort(-np.asarray(scores))
            batch_metrics = get_metrics(np.asarray(is_true)[order][None, :], self.topk)
            for key in m_all:
                m_all[key] += batch_metrics[key]
        dp = max(2, getattr(args, "decimal_place", 4))
        for key in m_all:
            m_all[key] = m_all[key] / max(eval_num, 1)
            logger.info("%s %.*f", key, dp, m_all[key])
        m_all["query_num"] = eval_num
        if rank_zero(self.mesh):
            with open(os.path.join(args.cache_train_dir, f"{ep}.0_RR_metrics"), "w",
                      encoding="utf-8") as fh:
                json.dump(m_all, fh, ensure_ascii=False)
        return m_all

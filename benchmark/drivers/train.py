"""Dual-encoder training: the port's ``Trainer.train_step`` on in-batch negatives.

Set-up draws ``pool_batches`` batches from the seed (``queries`` queries, each with
``passages_per_query`` passages, its positive first; lognormal lengths padded to the
configuration's ``q_max_len`` / ``p_max_len``) and moves them to the device once. It
builds one ``Trainer`` over the port's ``DRModel`` with the seeded weights and drives it
through the first ``checked_steps`` steps on the first batches, all different: those
steps' losses, each leaf's first gradient as AdamW holds it (its first moment over
1 - beta1) and each leaf's change after the last of them are what the check compares.
The same trainer then runs the window, cycling the pool; ``train_queries_per_s`` counts
the queries of the window's steps over its seconds, ended by a synchronize.

The reference follows the same steps from the same weights in float32
(``reference/train.py``). Readings: ``loss_gap`` (the worst step's relative loss gap),
``grad_gap`` (the worst leaf's first-gradient norm gap, against the larger of its norm
and the median leaf's) and ``change_gap`` (the same for the change, over the leaves the
reference's gradient moves: ``harness.compare.moved_leaves``).
"""

from __future__ import annotations

import sys

import torch

from harness import compare, refs
from harness.port import dual_encoder
from harness.traffic import lengths, numpy_rng, token_batch
from harness.weights import make_weights, piece_norms
from reference.precision import CASTS, strict_fp32
from reference.train import run_steps

BETA1 = 0.9


def make_batches(run):
    """[(query batch, passage batch)] of host int32 arrays, and their real lengths."""
    tr, cfg = run.traffic, run.config
    de, tokens = cfg["dual_encoder"], cfg["assumed"]["token_ids"]
    rng = numpy_rng(run.seed, "train")
    out = []
    for _ in range(tr["pool_batches"]):
        q_lens = lengths(rng, tr["queries"], tr["query_len"])
        p_lens = lengths(rng, tr["queries"] * tr["passages_per_query"], tr["passage_len"])
        out.append((token_batch(rng, q_lens, de["q_max_len"], tokens),
                    token_batch(rng, p_lens, de["p_max_len"], tokens), q_lens, p_lens))
    return out


class Driver:
    unit_span = "train_step"
    control_variants = ("control", "half_batch")

    def __init__(self, run):
        from denseretrievaltoolkits_torch.config import TrainingArguments
        from denseretrievaltoolkits_torch.train.trainer import Trainer

        self.run = run
        tr = run.traffic
        self.host = make_batches(run)
        dev = run.device
        self.batches = [({k: torch.as_tensor(v, dtype=torch.long, device=dev)
                          for k, v in q.items()},
                         {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                          for k, v in p.items()}) for q, p, _, _ in self.host]
        run.mark("batches")
        self.model, start = dual_encoder(run, serving=False)
        run.mark("model")
        args = TrainingArguments(output_dir=run.scratch, cache_train_dir=run.scratch,
                                 optimizer=tr["optimizer"], learning_rate=tr["learning_rate"])
        self.trainer = Trainer(args, self.model)
        params = dict(self.model.named_parameters())
        losses = []
        for s in range(tr["checked_steps"]):
            losses.append(self.trainer.train_step(self.batches[s]))
            if s == 0:
                state = self.trainer.optimizer.optimizer.state
                self.grad_norms = self.norms(
                    {n: state[p]["exp_avg"] / (1 - BETA1) if "exp_avg" in state.get(p, {})
                     else torch.zeros_like(p) for n, p in params.items()})
        self.losses = [float(v) for v in losses]
        run.mark("checked steps")
        self.change_norms = self.norms({n: p.detach() - start[n.split(".", 1)[1]]
                                        for n, p in params.items()})
        del start
        self.next = tr["checked_steps"]
        self.want = None  # the reference's readings, made once
        run.counters.update(units=0, steps=0, train_query_lengths=[], train_passage_lengths=[])

    def norms(self, tensors):
        """{parameter: norm} of {tower.leaf: tensor} (``harness.weights.pieces``)."""
        return piece_norms(self.run.config, tensors)

    def step(self) -> None:
        i = self.next % len(self.batches)
        self.trainer.train_step(self.batches[i])
        self.next += 1
        c = self.run.counters
        c["units"] += 1
        c["steps"] += 1
        c["train_query_lengths"].append(self.host[i][2])
        c["train_passage_lengths"].append(self.host[i][3])

    def finish(self) -> None:
        self.run.sync()

    def end_to_end(self, window_s: float):
        return {"train_queries_per_s":
                self.run.counters["steps"] * self.run.traffic["queries"] / window_s}

    def release(self) -> None:
        del self.trainer, self.model, self.batches
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, cast, half_batch: bool = False):
        strict_fp32()
        run, cfg = self.run, self.run.config
        weights = make_weights(cfg, run.seed, run.device)
        towers = {"lm_q": weights}
        if cfg["dual_encoder"]["untie_encoder"]:
            towers["lm_p"] = weights
        dev = run.device
        batches = [tuple({k: torch.as_tensor(v, device=dev) for k, v in b.items()}
                         for b in self.host[s][:2])
                   for s in range(run.traffic["checked_steps"])]
        return run_steps(towers, refs.encoder(cfg), cfg["dual_encoder"]["pooling"], batches,
                         run.traffic["learning_rate"], self.norms, cast, half_batch)

    def readings(self, variant: str):
        if self.want is None:
            self.want = self.reference(CASTS["exact"])
        want = self.want
        if variant == "sound":
            got = {"losses": self.losses, "grad_norms": self.grad_norms,
                   "change_norms": self.change_norms}
        elif variant == "control":
            got = self.reference(CASTS["fp8"])
        elif variant == "half_batch":
            got = self.reference(CASTS["exact"], half_batch=True)
        else:
            raise ValueError(variant)
        out = {"loss_gap": compare.loss_gap(got["losses"], want["losses"])}
        moved = compare.moved_leaves(want["grad_norms"])
        for name, what, keep in (("grad_gap", "grad_norms", None),
                                 ("change_gap", "change_norms", moved)):
            gaps = compare.leaf_gaps(got[what], want[what], keep)
            worst = max(gaps, key=gaps.get)
            print(f"{variant} {name}: worst {worst} {gaps[worst]!r}", file=sys.stderr)
            out[name] = gaps[worst]
        return out

"""Dense-retriever training loop.

Counterpart of ``Trainer`` in ``denseretrievaltoolkits_tpu/train/trainer.py``
(:42-267 and :598-697): warmup derived from ``warmup_ratio``, one optimizer
update per ``train_step``, the epoch loop with the shared ``prefetch``, a log
line and ``train_log.jsonl`` at the log cadence, a ``torch.profiler`` trace of
step 2 when ``profile_dir`` is set, the stop on a non-finite epoch loss, and
the save cadence: the deploy format under ``cache_train_dir/result{N}`` and a
resume checkpoint (``torch.save`` of params, optimizer state, epoch and step)
under ``output_dir/checkpoint/ep{N}``, in place of Orbax.

The model holds its parameters, so there is no ``params`` argument.
Evaluation (``eval_loader`` / ``test_loader``, and the corpus loader and
label kind it reads), the miner and a mesh are later slices: given one of the
four, the constructor raises.

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
from typing import Any, Dict

import torch

from ..data.loaders import prefetch
from .optimizers import get_optimizer

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = "state.pt"


class Trainer:
    """Trains a ``models.biencoder.DRModel`` in place."""

    def __init__(self, training_args, model, train_loader=None, eval_loader=None,
                 test_loader=None, mesh=None, miner=None):
        for given, what, item in ((eval_loader, "evaluation (eval_loader)", 2),
                                  (test_loader, "evaluation (test_loader)", 2),
                                  (miner, "hard-negative mining", 9),
                                  (mesh, "a device mesh", 13)):
            if given is not None:
                raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item {item})")
        self.training_args = training_args
        self.model = model
        self.train_loader = train_loader
        self.start_epoch = 0
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
        self.optimizer = get_optimizer(training_args, model.parameters())
        self.step = 0

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer update on a (query, passage) batch. Returns the loss
        as a device tensor: no per-step host sync (trainer.py:177-187)."""
        self.model.train()
        loss = self.model.forward(batch[0], batch[1])["loss"]
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def train(self) -> None:
        """Epoch loop with the log and save cadences (trainer.py:191-236)."""
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
        """Append a record to ``{output_dir}/train_log.jsonl``."""
        try:
            os.makedirs(self.training_args.output_dir, exist_ok=True)
            path = os.path.join(self.training_args.output_dir, "train_log.jsonl")
            with open(path, "a", encoding="utf-8") as fh:
                json.dump({"time": time.time(), **record}, fh)
                fh.write("\n")
        except OSError:  # logging must never kill training
            logger.debug("could not write train_log.jsonl", exc_info=True)

    # -- persistence ---------------------------------------------------------

    def save(self, i_epoch: int) -> None:
        """Deploy format under ``cache_train_dir/result{N}`` (the layout the
        JAX package and ``DRModelForInference.build`` load) and the resume
        checkpoint under ``output_dir/checkpoint/ep{N}``."""
        args = self.training_args
        self.model.save(os.path.join(args.cache_train_dir, f"result{i_epoch}"))
        self.save_checkpoint(os.path.join(args.output_dir, "checkpoint"), i_epoch)

    def save_checkpoint(self, path: str, epoch: int) -> None:
        """``path/ep{epoch}/state.pt``: params, optimizer state (with its update
        count), and ``epoch`` (epochs completed) and ``step``."""
        ckpt_dir = os.path.join(os.path.abspath(path), f"ep{epoch}")
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                   "meta": {"epoch": epoch, "step": self.step}}
        tmp = os.path.join(ckpt_dir, CHECKPOINT_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(ckpt_dir, CHECKPOINT_FILE))

    def load(self, filename: str, ckpt_type=None) -> None:
        """Resume params, optimizer state and step from a checkpoint dir.
        Training restarts at the first epoch the checkpoint did not complete
        (``ckpt_type`` given: at epoch 0, as the reference)."""
        # on the host: the optimizer moves its state to each parameter's device,
        # and keeps the update counts on the host as torch.optim wants them
        payload = torch.load(os.path.join(filename, CHECKPOINT_FILE), map_location="cpu",
                             weights_only=True)
        self.model.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.start_epoch = int(payload["meta"]["epoch"]) if ckpt_type is None else 0
        self.step = int(payload["meta"]["step"])

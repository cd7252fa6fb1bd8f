"""Optimizer factory with optax's semantics on ``torch.optim``.

Counterpart of ``denseretrievaltoolkits_tpu/train/optimizers.py``: ``adam``,
``adamw`` and ``sgd`` with the user's ``optimizer_kwargs`` under optax's names
and defaults, and a schedule composed in. Two places where torch's defaults
differ from optax's are pinned here:

- ``optax.adamw`` decays with ``weight_decay=1e-4``; ``torch.optim.AdamW``
  defaults to 1e-2. Both decay every parameter and put eps outside the sqrt,
  so the update rules agree once the decay matches.
- optax evaluates the schedule at the count of updates done before this one
  (0 for the first), and the schedules clamp it to >= 1. The lr is written
  into every param group right before each update; ``LambdaLR`` is not used
  (it divides by a base lr that may be 0).

Given a model with LoRA adapters, only the adapters and the heads train.

``adagrad``, ``rmsprop`` and ``adafactor`` raise: optax's formulas differ from
torch's (accumulator init, where eps sits, decay), so mapping them onto
``torch.optim`` would change the result.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Union

import torch

from .schedulers import get_schedule

logger = logging.getLogger(__name__)

_NOT_PORTED = ("adagrad", "rmsprop", "adafactor")


def _adam_kwargs(name, kw):
    out = {"betas": (kw.pop("b1", 0.9), kw.pop("b2", 0.999)), "eps": kw.pop("eps", 1e-8)}
    if name == "adamw":
        out["weight_decay"] = kw.pop("weight_decay", 1e-4)
    return out


def _sgd_kwargs(name, kw):
    return {"momentum": kw.pop("momentum", None) or 0.0, "nesterov": kw.pop("nesterov", False)}


_FACTORIES = {
    "adam": (torch.optim.Adam, _adam_kwargs),
    "adamw": (torch.optim.AdamW, _adam_kwargs),
    "sgd": (torch.optim.SGD, _sgd_kwargs),
}


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose lr follows ``schedule`` (a float or
    a ``step -> lr`` function), set before each update at the count of updates
    done so far."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Union[float, Callable[[int], float]]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0

    def step(self) -> None:
        lr = self.schedule(self.count) if callable(self.schedule) else self.schedule
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def get_optimizer(training_args, params: Union[torch.nn.Module, Iterable[torch.nn.Parameter]]
                  ) -> ScheduledOptimizer:
    """The optimizer over ``params``: a module's parameters, or only its LoRA-trainable
    ones when it has adapters (``models/lora.py:lora_trainable``, which takes the
    gradient off the base). A parameter outside the optimizer never moves, whatever
    the weight decay or schedule: the reference's ``multi_transform`` with
    ``set_to_zero`` (optimizers.py:46-65 there) leaves the frozen base bit-unchanged."""
    if isinstance(params, torch.nn.Module):
        from ..models.lora import has_lora, lora_trainable

        if has_lora(params):
            logger.info("LoRA adapters found: freezing the base parameters")
            params = lora_trainable(params)
        else:
            params = params.parameters()
    name = training_args.optimizer
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r}: optax's {name} differs from torch.optim's (accumulator init, "
            f"eps placement, decay); its port is ROADMAP queue 1, item 'Optimizers adagrad, "
            f"rmsprop and adafactor'")
    if name not in _FACTORIES:
        logger.warning("Unknown optimizer %r; defaulting to adamw", name)
        name = "adamw"
    factory, translate = _FACTORIES[name]
    kw = dict(training_args.optimizer_kwargs)
    torch_kw = translate(name, kw)
    if kw:
        raise NotImplementedError(
            f"optimizer {name!r}: optax kwargs {sorted(kw)} are not ported")
    schedule = get_schedule(training_args.scheduler, training_args.learning_rate,
                            training_args.scheduler_kwargs)
    lr0 = schedule(0) if callable(schedule) else schedule
    return ScheduledOptimizer(factory(params, lr=lr0, **torch_kw), schedule)

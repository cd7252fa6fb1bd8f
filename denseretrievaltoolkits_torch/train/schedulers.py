"""Learning-rate schedules as ``step -> lr`` functions.

Counterpart of ``denseretrievaltoolkits_tpu/train/schedulers.py:22-99``: the
same four schedules (inverse-sqrt / cosine / linear / constant), all with
linear warmup, and ``get_schedule``'s defaults (``max_lr`` = the base learning
rate, ``init_lr`` = 0). ``step`` is the number of updates done before the one
the lr is for, as optax counts; it is clamped to >= 1 as the reference does,
so updates 0 and 1 share one lr.
"""

from __future__ import annotations

import math
from typing import Callable, Union


def _warmup(step, init_lr, max_lr, n_warmup_steps):
    return init_lr + (max_lr - init_lr) / n_warmup_steps * step


def inverse_sqrt_schedule(init_lr: float, max_lr: float, n_warmup_steps: int):
    decay_k = max_lr * (n_warmup_steps ** 0.5)

    def schedule(step: int) -> float:
        step = max(step, 1)
        if step <= n_warmup_steps:
            return _warmup(step, init_lr, max_lr, n_warmup_steps)
        return decay_k * step ** -0.5

    return schedule


def cosine_schedule(init_lr: float, max_lr: float, n_warmup_steps: int, max_steps: int):
    half_delta = (max_lr - init_lr) / 2
    decay_k = math.pi / (max_steps - n_warmup_steps)

    def schedule(step: int) -> float:
        step = max(step, 1)
        if step <= n_warmup_steps:
            return _warmup(step, init_lr, max_lr, n_warmup_steps)
        return init_lr + half_delta * (1.0 + math.cos(decay_k * (step - n_warmup_steps)))

    return schedule


def linear_schedule(init_lr: float, max_lr: float, n_warmup_steps: int, max_steps: int):
    decay_k = (max_lr - init_lr) / (max_steps - n_warmup_steps)

    def schedule(step: int) -> float:
        step = max(step, 1)
        if step <= n_warmup_steps:
            return _warmup(step, init_lr, max_lr, n_warmup_steps)
        return max_lr - decay_k * (step - n_warmup_steps)

    return schedule


def constant_schedule(init_lr: float, max_lr: float, n_warmup_steps: int):
    def schedule(step: int) -> float:
        step = max(step, 1)
        if step <= n_warmup_steps:
            return _warmup(step, init_lr, max_lr, n_warmup_steps)
        return max_lr

    return schedule


SCHEDULES = {
    "inverse": inverse_sqrt_schedule,
    "cosine": cosine_schedule,
    "linear": linear_schedule,
    "constant": constant_schedule,
}


def get_schedule(name, learning_rate: float,
                 scheduler_kwargs: dict) -> Union[float, Callable[[int], float]]:
    """A schedule by name, or the constant ``learning_rate`` when ``name`` is None."""
    if name is None:
        return learning_rate
    if name not in SCHEDULES:
        raise ValueError(f"Unknown scheduler {name!r}; choose from {sorted(SCHEDULES)}")
    kwargs = dict(scheduler_kwargs)
    kwargs.setdefault("max_lr", learning_rate)
    kwargs.setdefault("init_lr", 0.0)
    return SCHEDULES[name](**kwargs)

"""Optimizer factory with optax's semantics on ``torch.optim``.

Counterpart of ``denseretrievaltoolkits_tpu/train/optimizers.py``: the
reference's menu ``adam``, ``adamw``, ``sgd``, ``adagrad``, ``rmsprop`` and
``adafactor`` with the user's ``optimizer_kwargs`` (``adafactor_kwargs``
merged over them for adafactor, as optimizers.py:41-43 there) under optax's
names and defaults, and a schedule composed in.

- ``adam``, ``adamw`` and ``sgd`` map onto ``torch.optim``. ``optax.adamw``
  decays with ``weight_decay=1e-4``; ``torch.optim.AdamW`` defaults to 1e-2.
  Both decay every parameter and put eps outside the sqrt, so the update
  rules agree once the decay matches.
- ``adagrad``, ``rmsprop`` and ``adafactor`` are written here to optax
  0.2.6's formulas (:class:`Adagrad`, :class:`RMSProp`, :class:`Adafactor`):
  ``torch.optim``'s namesakes start their accumulators elsewhere, put eps
  elsewhere and decay otherwise.
- optax evaluates the schedule at the count of updates done before this one
  (0 for the first), and the schedules clamp it to >= 1. The lr is written
  into every param group right before each update; ``LambdaLR`` is not used
  (it divides by a base lr that may be 0).

An optax kwarg with no translation here raises. Given a model with LoRA
adapters, only the adapters and the heads train. Under tensor parallelism
(``parallel/mesh.py``) each rank's optimizer steps its parts of the cut leaves;
adafactor sums its reductions over the model group.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from .schedulers import get_schedule

logger = logging.getLogger(__name__)


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``: the sum of squares starts at
    ``initial_accumulator_value``; the step is ``-lr g rsqrt(sum + eps)``, 0
    where the sum is 0."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                g = p.grad
                acc = state["sum"]
                acc.add_(g * g)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    torch.zeros_like(acc))
                p.add_(-group["lr"] * (scale * g))


class RMSProp(torch.optim.Optimizer):
    """``optax.rmsprop``: ``nu = decay nu + (1 - decay) g^2`` from
    ``initial_scale``; ``centered`` also tracks the mean ``mu`` and scales by
    ``nu - mu^2``; ``eps`` inside the sqrt unless ``eps_in_sqrt`` is false;
    ``bias_correction`` divides by ``1 - decay^t``. The lr-scaled update then
    goes through a ``momentum`` trace (``nesterov``: ``u + m trace``), as optax
    chains them."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 bias_correction: bool = False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
                                      eps_in_sqrt=eps_in_sqrt, centered=centered,
                                      momentum=momentum, nesterov=nesterov,
                                      bias_correction=bias_correction))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps, m = group["decay"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                    if group["centered"]:
                        state["mu"] = torch.zeros_like(p)
                    if m is not None:
                        state["trace"] = torch.zeros_like(p)
                state["step"] += 1
                nu = state["nu"]
                nu.copy_((1 - decay) * (g * g) + decay * nu)
                nu_hat = nu
                if group["centered"]:
                    mu = state["mu"]
                    mu.copy_((1 - decay) * g + decay * mu)
                    mu_hat = mu
                if group["bias_correction"]:
                    corr = 1 - torch.tensor(decay, dtype=p.dtype) ** state["step"]
                    nu_hat = nu / corr.to(p.device)
                    if group["centered"]:
                        mu_hat = mu / corr.to(p.device)
                var = nu_hat - mu_hat * mu_hat if group["centered"] else nu_hat
                scale = (torch.rsqrt(var + eps) if group["eps_in_sqrt"]
                         else 1 / (torch.sqrt(var) + eps))
                update = -group["lr"] * (scale * g)
                if m is not None:
                    trace = state["trace"]
                    trace.copy_(update + m * trace)
                    update = update + m * trace if group["nesterov"] else trace
                p.add_(update)


def _factored_dims(shape, factored: bool, min_dim: int) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second largest and the largest axes, when both have at
    least ``min_dim`` (optax's ``_factored_dims``, its argsort's order at ties)."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor``, its chain in order: the factored second moments
    (over the two largest axes where both are >= ``min_dim_size_to_factor``;
    decay ``1 - (t - decay_offset + 1)^-decay_rate``; ``eps`` added to g^2),
    the clip to a block RMS of ``clipping_threshold``, the lr, the
    parameter's block RMS (at least 1e-3) with ``multiply_by_parameter_scale``,
    an undebiased ``momentum`` EMA, ``weight_decay_rate`` times the parameter
    (not lr-scaled, as optax adds it), then the sign flip. A parameter cut over a
    mesh's model axis is factored by its full shape, and its moments' means over
    the cut axis, the clip's RMS and the parameter's RMS sum over the model group
    (:class:`_CutLeaf`): the update is the one-process update's part. The
    element-wise optimizers need nothing of the kind."""

    def __init__(self, params, lr: float, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0,
                 multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
                 weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
                 factored: bool = True):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
            decay_offset=decay_offset, multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay_rate=weight_decay_rate, eps=eps, factored=factored))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                cut = _CutLeaf(p)
                dims = _factored_dims(cut.full, group["factored"],
                                      group["min_dim_size_to_factor"])
                if not state:
                    state["step"] = 0
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        state["v_row"] = torch.zeros_like(p.mean(dim=dims[1]))
                        state["v_col"] = torch.zeros_like(p.mean(dim=dims[0]))
                    if group["momentum"] is not None:
                        state["ema"] = torch.zeros_like(p)
                # optax's count: updates done before this one, in fp32
                t = torch.tensor(state["step"] - group["decay_offset"] + 1, dtype=torch.float32)
                beta = float(1.0 - t ** (-group["decay_rate"]))
                state["step"] += 1
                g_sqr = g * g + group["eps"]
                if dims is None:
                    v = state["v"]
                    v.copy_(beta * v + (1.0 - beta) * g_sqr)
                    u = g * v ** -0.5
                else:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.copy_(beta * v_row + (1.0 - beta) * cut.mean(g_sqr, d0))
                    v_col.copy_(beta * v_col + (1.0 - beta) * cut.mean(g_sqr, d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = cut.mean(v_row, reduced_d1, dropped=d0, keepdim=True,
                                            size=cut.full[d1])
                    row_factor = (v_row / row_col_mean) ** -0.5
                    col_factor = v_col ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                if group["clipping_threshold"] is not None:
                    u = u / torch.clamp(cut.rms(u) / group["clipping_threshold"], min=1.0)
                u = group["lr"] * u
                if group["multiply_by_parameter_scale"]:
                    rms = cut.rms(p)
                    u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
                if group["momentum"] is not None:
                    ema = state["ema"]
                    ema.copy_((1 - group["momentum"]) * u + group["momentum"] * ema)
                    u = ema
                if group["weight_decay_rate"] is not None:
                    u = u + group["weight_decay_rate"] * p
                p.add_(-u)


class _CutLeaf:
    """Reductions over a parameter's full array when it is cut over a mesh's model
    axis (``parallel/mesh.py:shard_module``): a sum over the cut axis, or over every
    element, adds up the model ranks' partial sums; optax runs on the full array."""

    def __init__(self, p: torch.Tensor):
        self.spec = getattr(p, "tp_shard", None)
        self.mesh = getattr(p, "tp_mesh", None)
        self.full = tuple(p.shape) if self.spec is None else self.spec.full_shape(p.shape)

    def mean(self, x: torch.Tensor, dim: int, dropped: Optional[int] = None,
             keepdim: bool = False, size: Optional[int] = None) -> torch.Tensor:
        """The mean over ``dim`` of ``x``, which is the parameter with axis ``dropped``
        reduced away (None: the parameter itself); ``size`` is the full length of
        ``dim``."""
        axis = None if self.spec is None else self.spec.axis
        if axis is not None and dropped is not None:
            axis = None if axis == dropped else axis - (axis > dropped)
        if axis != dim:
            return x.mean(dim=dim, keepdim=keepdim)
        total = self.mesh.model_sum_(x.sum(dim=dim, keepdim=keepdim))
        return total / (self.full[dim] if size is None else size)

    def rms(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec is None:
            return torch.sqrt(torch.mean(x * x))
        total = self.mesh.model_sum_(torch.sum(x * x).reshape(1)).reshape(())
        return torch.sqrt(total / float(np.prod(self.full)))


def _adam_kwargs(name, kw):
    out = {"betas": (kw.pop("b1", 0.9), kw.pop("b2", 0.999)), "eps": kw.pop("eps", 1e-8)}
    if name == "adamw":
        out["weight_decay"] = kw.pop("weight_decay", 1e-4)
    return out


def _sgd_kwargs(name, kw):
    return {"momentum": kw.pop("momentum", None) or 0.0, "nesterov": kw.pop("nesterov", False)}


def _taking(*names):
    """The translation of optax kwargs that keep their names here."""
    def translate(name, kw):
        return {n: kw.pop(n) for n in names if n in kw}
    return translate


_FACTORIES = {
    "adam": (torch.optim.Adam, _adam_kwargs),
    "adamw": (torch.optim.AdamW, _adam_kwargs),
    "sgd": (torch.optim.SGD, _sgd_kwargs),
    "adagrad": (Adagrad, _taking("initial_accumulator_value", "eps")),
    "rmsprop": (RMSProp, _taking("decay", "eps", "initial_scale", "eps_in_sqrt", "centered",
                                 "momentum", "nesterov", "bias_correction")),
    "adafactor": (Adafactor, _taking("min_dim_size_to_factor", "decay_rate", "decay_offset",
                                     "multiply_by_parameter_scale", "clipping_threshold",
                                     "momentum", "weight_decay_rate", "eps", "factored")),
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
    if name not in _FACTORIES:
        logger.warning("Unknown optimizer %r; defaulting to adamw", name)
        name = "adamw"
    factory, translate = _FACTORIES[name]
    kw = dict(training_args.optimizer_kwargs)
    if name == "adafactor":
        kw.update(getattr(training_args, "adafactor_kwargs", {}) or {})
    torch_kw = translate(name, kw)
    if kw:
        raise NotImplementedError(
            f"optimizer {name!r}: optax kwargs {sorted(kw)} are not ported")
    schedule = get_schedule(training_args.scheduler, training_args.learning_rate,
                            training_args.scheduler_kwargs)
    lr0 = schedule(0) if callable(schedule) else schedule
    return ScheduledOptimizer(factory(params, lr=lr0, **torch_kw), schedule)

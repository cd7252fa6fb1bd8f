"""Data and tensor parallelism over processes: the mesh, its collectives and the step.

Counterpart of ``denseretrievaltoolkits_tpu/parallel/mesh.py``. A JAX mesh
device becomes one PyTorch rank: one process per card under
``torch.distributed``, each with an explicit device. :func:`make_mesh` lays the
world out as ``dp_size x tp_size``, rank r at data index ``r // tp_size`` and
model index ``r % tp_size`` (the JAX mesh's ``reshape(dp, tp)``). The ranks of
one model index form a data group (``DATA_AXIS``), the ranks of one data index
a model group (``MODEL_AXIS``); every rank creates every group, in the same
order. A single process driving several cards is not ported.

The reference trains with DDP and a global negative pool
(``negatives_x_device``). Here, as in the JAX step, every rank computes the
contrastive loss over the whole global batch:

- :func:`gather_rows` all-gathers each rank's query and passage reps over the
  data group with autograd: forward ``all_gather``, backward ``all_reduce``
  (sum) of the gathered gradient and this rank's own rows of it.
  ``torch.distributed.nn``'s gather runs its backward as an ``all_to_all``,
  which gloo lacks.
- :func:`data_parallel_backward`: K3 / K4 over the gathered Q = dp q by
  P = dp p on every rank; every rank's loss is the same, so the summed rep
  gradient is dp times the true one, and :func:`all_reduce_grads` averages
  the parameter gradients over the data group: the result is the full-batch
  gradient of one process. With ``negatives_x_device`` off each rank's loss
  covers its own block and the mean over ranks is taken (trainer.py:99-126
  there).
- the chunked step under the mesh is ``train/grad_cache.py``'s
  ``grad_cache_backward(..., mesh=)``.

Tensor parallelism is GSPMD's Megatron layout (mesh.py:40-60 there):
:func:`shard_module` cuts exactly the leaves :data:`LAYER_RULES` names and
replicates the rest. Column-parallel: the fused qkv projection (a rank's
columns are its heads' columns of each of the q, k and v thirds, never a
contiguous third of 3H) and ``wi``'s kernel and bias; row-parallel: ``o`` and
``wo``'s kernels. ``models/bert.py:encoder_block`` runs a sharded layer on the
model group (:func:`copy_to_model`, :func:`sum_over_model`, :func:`gather_leaf`).
The ranks of a model group see the same rows, so every replicated leaf's
gradient is the same on each of them, and every gradient is averaged over the
data group only. :func:`gathered` puts the full arrays back for a save.

Every rank must make the same collective calls in the same order: the
loaders give every rank the same number of equal batches. Parameters start
equal by :meth:`Mesh.broadcast_module` from rank 0, and stay equal because
every rank applies the same reduced gradient.

Two ranks that share one card use ``gloo``, whose collectives take CUDA
tensors through the host; NCCL refuses a card twice. gloo has no
``reduce_scatter``, ``all_to_all`` or ``ReduceOp.AVG``: every collective here is
an ``all_reduce`` (sum), an ``all_gather`` or a broadcast. Nothing here chooses
or changes the backend, or moves a tensor to the host on its own.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# leaf of a models.bert.BertLayer -> (axis it is cut along, sections of that axis cut
# alike): the JAX rules (mesh.py:47-60 there) on the port's fused [H, 3H] qkv
LAYER_RULES: Dict[str, Tuple[int, int]] = {
    "qkv_kernel": (1, 3), "qkv_bias": (0, 3),
    "o_kernel": (0, 1),
    "wi_kernel": (1, 1), "wi_bias": (0, 1),
    "wo_kernel": (0, 1),
}


class Mesh:
    """``DATA_AXIS`` over the ranks of ``group`` (the default process group when
    None) and, with ``model_group``, ``MODEL_AXIS`` over that group's ranks.
    ``size`` / ``rank`` are the data axis's, ``tp`` / ``tp_rank`` the model
    axis's. Without a started group it is one rank, and its collectives return
    their inputs."""

    def __init__(self, group=None, model_group=None):
        self.group = group
        self.model_group = model_group
        self.live = dist.is_available() and dist.is_initialized()
        self.size = dist.get_world_size(group) if self.live else 1
        self.rank = dist.get_rank(group) if self.live else 0
        self.tp = dist.get_world_size(model_group) if model_group is not None else 1
        self.tp_rank = dist.get_rank(model_group) if model_group is not None else 0
        self.shape = {DATA_AXIS: self.size, MODEL_AXIS: self.tp}

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every data rank's ``x`` (same shape on every rank), in rank order."""
        if not self.live:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

    def all_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the data ranks, in place."""
        if self.live:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def model_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's ``x``, in model-rank order."""
        if self.model_group is None:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x.contiguous(), group=self.model_group)
        return parts

    def model_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model ranks, in place."""
        if self.model_group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.model_group)
        return x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data ranks (a new tensor)."""
        return self.all_sum_(x.detach().clone()) / self.size

    def global_rank(self, data_rank: int) -> int:
        """The process-group rank of this model index's ``data_rank``."""
        if not self.live or self.group is None:
            return data_rank
        return dist.get_global_rank(self.group, data_rank)

    def barrier(self) -> None:
        """The ranks of this data group meet here (a sharded index's save: the
        model ranks > 0 write none)."""
        if self.live:
            dist.barrier(group=self.group)

    def broadcast_module(self, module: torch.nn.Module, src: int = 0) -> None:
        """Data rank ``src``'s parameters and buffers, in place on every rank of
        its data group. An unsharded module on a mesh with a model axis takes
        process ``src``'s over the whole world, so that every model rank cuts its
        shards out of the same arrays."""
        if not self.live:
            return
        whole = self.tp > 1 and not is_sharded(module)
        group = None if whole else self.group
        root = src if whole else self.global_rank(src)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, root, group=group)


def make_mesh(dp_size: int = -1, tp_size: int = 1) -> Mesh:
    """The ``dp_size x tp_size`` mesh over the started process group
    (mesh.py:28-37 there): ``dp_size`` -1 is the world size over ``tp_size``,
    and their product must be the world size (one rank a card). Without a
    process group the world is one rank."""
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    if tp_size < 1 or world % tp_size:
        raise ValueError(f"tp_size {tp_size} must divide the world size {world}")
    if dp_size == -1:
        dp_size = world // tp_size
    if dp_size * tp_size != world:
        raise ValueError(f"dp_size x tp_size = {dp_size} x {tp_size} must be the world size "
                         f"{world} (one rank a card)")
    if tp_size == 1:
        mesh = Mesh()
    else:
        # every rank creates every group, in one order: data groups, then model groups
        data = [dist.new_group([d * tp_size + m for d in range(dp_size)])
                for m in range(tp_size)]
        model = [dist.new_group([d * tp_size + m for m in range(tp_size)])
                 for d in range(dp_size)]
        rank = dist.get_rank()
        mesh = Mesh(data[rank % tp_size], model_group=model[rank // tp_size])
    return mesh


# -- tensor parallelism ----------------------------------------------------------------------


@dataclass(frozen=True)
class Shard:
    """How a leaf is cut over the model axis: along ``axis``, whose ``groups``
    equal sections (q, k, v of the fused projection) are each cut into
    ``parts``; this rank holds part ``index`` of every section."""

    axis: int
    groups: int
    parts: int
    index: int

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        shape = list(full.shape)
        n = shape[self.axis]
        if n % (self.groups * self.parts):
            raise ValueError(f"axis {self.axis} of {tuple(full.shape)} does not split into "
                             f"{self.groups} x {self.parts}")
        w = n // (self.groups * self.parts)
        x = full.reshape(shape[:self.axis] + [self.groups, self.parts * w]
                         + shape[self.axis + 1:])
        x = x.narrow(self.axis + 1, self.index * w, w)
        return x.reshape(shape[:self.axis] + [self.groups * w] + shape[self.axis + 1:])

    def join(self, parts: List[torch.Tensor]) -> torch.Tensor:
        shape = list(parts[0].shape)
        n = shape[self.axis]
        split = [p.reshape(shape[:self.axis] + [self.groups, n // self.groups]
                           + shape[self.axis + 1:]) for p in parts]
        full = torch.cat(split, dim=self.axis + 1)
        return full.reshape(shape[:self.axis] + [n * self.parts] + shape[self.axis + 1:])

    def full_shape(self, shape) -> Tuple[int, ...]:
        out = list(shape)
        out[self.axis] *= self.parts
        return tuple(out)


def _bert_layers(module: torch.nn.Module):
    from ..models.bert import BertLayer

    return [m for m in module.modules() if isinstance(m, BertLayer)]


def is_sharded(module: torch.nn.Module) -> bool:
    """Whether ``module`` holds BERT layers cut over a model axis."""
    return any(getattr(layer, "tp", None) is not None for layer in _bert_layers(module))


def param_shard(param: torch.Tensor) -> Optional[Shard]:
    """The :class:`Shard` of a cut leaf, None for a replicated one."""
    return getattr(param, "tp_shard", None)


def shard_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Cut every BERT layer of ``module`` over ``mesh``'s model axis, in place
    (``shard_params``, mesh.py:63-78 there): the leaves of :data:`LAYER_RULES`
    keep this rank's part and learn their :class:`Shard`, the rest stay
    whole; each layer then runs its block on the model group. T5 towers,
    embeddings, LayerNorms, the pooler, heads and LoRA adapters stay
    replicated. Optimizer state made before this is stale: make it after."""
    from ..models.bert import BertEncoder

    if mesh.tp == 1:
        return
    for enc in [m for m in module.modules() if isinstance(m, BertEncoder)]:
        c = enc.config
        for what, n in (("heads", c.num_attention_heads), ("hidden width", c.hidden_size),
                        ("MLP width", c.intermediate_size)):
            if n % mesh.tp:
                raise ValueError(f"tensor parallelism: the {what} {n} do not split over "
                                 f"tp_size {mesh.tp}")
        for layer in enc.layers:
            if getattr(layer, "tp", None) is not None:
                continue
            for name, (axis, groups) in LAYER_RULES.items():
                p = getattr(layer, name)
                spec = Shard(axis, groups, mesh.tp, mesh.tp_rank)
                p.data = spec.cut(p.data).contiguous()
                p.tp_shard, p.tp_mesh = spec, mesh
            layer.tp = mesh


def _join_leaf(mesh: Mesh, shard: torch.Tensor, spec: Shard) -> torch.Tensor:
    return spec.join(mesh.model_gather(shard))


@contextlib.contextmanager
def gathered(module: torch.nn.Module):
    """Within the block every cut leaf of ``module`` holds its full array
    (all-gathered over the model group: a collective on every rank of the
    world), after it its shard again; yields whether this rank writes (global
    rank 0, or an unsharded module)."""
    layers = [layer for layer in _bert_layers(module) if getattr(layer, "tp", None) is not None]
    if not layers:
        yield True
        return
    mesh = layers[0].tp
    kept = []
    with torch.no_grad():
        for layer in layers:
            for name in LAYER_RULES:
                p = getattr(layer, name)
                kept.append((p, p.data))
                p.data = _join_leaf(mesh, p.data, p.tp_shard)
    try:
        yield mesh.rank == 0 and mesh.tp_rank == 0
    finally:
        for p, data in kept:
            p.data = data


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group in
    fp32 (Megatron's f: the input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_sum_(grad.to(torch.float32, copy=True)).to(grad.dtype), None


class _SumOverModel(torch.autograd.Function):
    """The sum over the model group forward (Megatron's g: the output of a
    row-parallel product, summed in fp32); identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_sum_(x.float().contiguous()).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLeaf(torch.autograd.Function):
    """A cut leaf's full array; the backward keeps this rank's part of the
    gradient (every model rank computes the same full gradient)."""

    @staticmethod
    def forward(ctx, shard, mesh, spec):
        ctx.spec = spec
        return _join_leaf(mesh, shard, spec)

    @staticmethod
    def backward(ctx, grad):
        return ctx.spec.cut(grad).contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh) if torch.is_grad_enabled() else x


def sum_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if torch.is_grad_enabled():
        return _SumOverModel.apply(x, mesh)
    return mesh.model_sum_(x.float().contiguous()).to(x.dtype)


def gather_leaf(param: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full array of a cut leaf, differentiable."""
    spec = param_shard(param)
    if torch.is_grad_enabled():
        return _GatherLeaf.apply(param, mesh, spec)
    return _join_leaf(mesh, param, spec)


class _GatherRows(torch.autograd.Function):
    """All ranks' rows joined; the backward sums the joined gradient over the
    ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        return torch.cat(mesh.all_gather(x))

    @staticmethod
    def backward(ctx, grad):
        mesh, n = ctx.mesh, ctx.rows
        grad = mesh.all_sum_(grad.contiguous().clone())
        return grad[mesh.rank * n:(mesh.rank + 1) * n], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[world rows, ...]: every rank's ``x`` in rank order, differentiable
    when ``x`` requires grad."""
    if x.requires_grad:
        return _GatherRows.apply(x, mesh)
    return torch.cat(mesh.all_gather(x))


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: Mesh, mean: bool) -> None:
    """Sum (``mean``: average) every ``.grad`` over the data ranks: one
    collective per dtype and device over a flat copy of the gradients. Cut and
    whole leaves alike: the model axis needs no reduction here."""
    if not mesh.live:
        return
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in buckets.values():
        flat = mesh.all_sum_(torch.cat([g.reshape(-1) for g in grads]))
        if mean:
            flat /= mesh.size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def data_parallel_backward(model, query, passage, mesh: Mesh,
                           negatives_x_device: bool = True) -> torch.Tensor:
    """Loss and parameter gradients of this rank's (query, passage) block
    under the mesh (module docstring): the global loss over every rank's
    reps, or with ``negatives_x_device`` off the mean of the ranks' own
    losses. ``.grad`` ends equal on every rank; returns the loss (the same on
    every rank) as a detached device scalar."""
    if negatives_x_device:
        q = model._reps(*model._towers("query"), query)
        p = model._reps(*model._towers("passage"), passage)
        loss, _ = model.loss(gather_rows(q, mesh), gather_rows(p, mesh))
    else:
        loss = model.forward(query, passage)["loss"]
    loss.backward()
    all_reduce_grads(model.parameters(), mesh, mean=True)
    return loss.detach() if negatives_x_device else mesh.mean(loss)


def rank_zero(mesh: Optional[Mesh]) -> bool:
    """True on the rank that writes files (global rank 0, or no mesh)."""
    return mesh is None or (mesh.rank == 0 and mesh.tp_rank == 0)

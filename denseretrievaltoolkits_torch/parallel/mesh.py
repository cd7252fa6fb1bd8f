"""Data parallelism over processes: the mesh, its collectives and the step.

Counterpart of ``denseretrievaltoolkits_tpu/parallel/mesh.py``. A JAX mesh
device becomes one PyTorch rank: one process per card under
``torch.distributed``, each with an explicit device; the mesh's ``DATA_AXIS``
is the ranks of the default process group, so ``dp_size`` is the world size.
A single process driving several cards is not ported, nor is GSPMD's
Megatron sharding over ``MODEL_AXIS`` (mesh.py:40-81 there): ``tp_size`` > 1
raises, naming its ROADMAP item.

The reference trains with DDP and a global negative pool
(``negatives_x_device``). Here, as in the JAX step, every rank computes the
contrastive loss over the whole global batch:

- :func:`gather_rows` all-gathers each rank's query and passage reps with
  autograd: forward ``all_gather``, backward ``all_reduce`` (sum) of the
  gathered gradient and this rank's own rows of it. ``torch.distributed.nn``'s
  gather runs its backward as an ``all_to_all``, which gloo lacks.
- :func:`data_parallel_backward`: K3 / K4 over the gathered Q = world q by
  P = world p on every rank; every rank's loss is the same, so the summed
  rep gradient is world times the true one, and :func:`all_reduce_grads`
  averages the parameter gradients: the result is the full-batch gradient of
  one process. With ``negatives_x_device`` off each rank's loss covers its own
  block and the mean over ranks is taken (trainer.py:99-126 there).
- the chunked step under the mesh is ``train/grad_cache.py``'s
  ``grad_cache_backward(..., mesh=)``.

Every rank must make the same collective calls in the same order: the
loaders give every rank the same number of equal batches. Parameters start
equal by :meth:`Mesh.broadcast_module` from rank 0, and stay equal because
every rank applies the same reduced gradient.

Two ranks that share one card use ``gloo``, whose collectives take CUDA
tensors through the host; NCCL refuses a card twice. Nothing here chooses
or changes the backend, or moves a tensor to the host on its own.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TP_ITEM = "`parallel/` tensor parallelism (`tp_size > 1`)"


def refuse_tensor_parallel(tp_size: int) -> None:
    """``tp_size`` > 1 raises: the Megatron shards are a later ROADMAP item."""
    if tp_size > 1:
        raise NotImplementedError(f"tensor parallelism is not ported yet (ROADMAP queue 1, "
                                  f"item '{TP_ITEM}')")


class Mesh:
    """The ranks of ``group`` (the default process group when None) along
    ``DATA_AXIS``. Without a started group it is one rank, and its
    collectives return their inputs."""

    def __init__(self, group=None):
        self.group = group
        self.live = dist.is_available() and dist.is_initialized()
        self.size = dist.get_world_size(group) if self.live else 1
        self.rank = dist.get_rank(group) if self.live else 0
        self.shape = {DATA_AXIS: self.size, MODEL_AXIS: 1}

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (same shape on every rank), in rank order."""
        if not self.live:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

    def all_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place."""
        if self.live:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks (a new tensor)."""
        return self.all_sum_(x.detach().clone()) / self.size

    def barrier(self) -> None:
        if self.live:
            dist.barrier(group=self.group)

    def broadcast_module(self, module: torch.nn.Module, src: int = 0) -> None:
        """Rank ``src``'s parameters and buffers, in place on every rank."""
        if not self.live:
            return
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src, group=self.group)


def make_mesh(dp_size: int = -1, tp_size: int = 1) -> Mesh:
    """The data-parallel mesh over the started process group. ``dp_size`` is
    the world size (-1: whatever it is); ``tp_size`` > 1 raises."""
    refuse_tensor_parallel(tp_size)
    mesh = Mesh()
    if dp_size not in (-1, mesh.size):
        raise ValueError(f"dp_size {dp_size} must be the world size {mesh.size} (one rank a "
                         f"card) or -1")
    return mesh


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
    """Sum (``mean``: average) every ``.grad`` over the ranks: one collective
    per dtype and device over a flat copy of the gradients."""
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
    """True on the rank that writes files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0

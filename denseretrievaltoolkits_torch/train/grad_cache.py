"""Gradient-cache contrastive training: the full-batch loss and gradient with
the activations of one chunk at a time.

Counterpart of ``denseretrievaltoolkits_tpu/train/grad_cache.py``:

1. :func:`encode_chunks`: every chunk encoded under ``torch.no_grad``, no
   graph kept, the chunks' reps joined;
2. :func:`rep_grads`: the model's full-batch contrastive loss on the joined
   reps (K3 forward and K4 backward with ``fused_loss`` where P % Q == 0, the
   plain loss otherwise: ``DRModel.loss``) and ``torch.autograd.grad`` of it
   with respect to both reps, [Q, D] and [P, D];
3. :func:`backward_chunks`: each chunk encoded again with its graph and
   ``reps.backward(its slice of the rep gradient)``, so ``.grad`` accumulates
   over the chunks and over both sides (the same tower when tied).

The loss sees the whole in-batch negative pool, and the peak activation memory
is one chunk's. A side of B rows runs in ``max(1, B // chunk_size)`` chunks of
equal size, as the reference's ``_chunk``: B must divide evenly, else
:func:`n_chunks` raises; nothing is padded.

The port has no dropout, so the encode of pass 3 repeats pass 1's reps, and
the parameter gradients equal the full-batch step's up to the order of fp32
sums.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..parallel.mesh import Mesh, gather_rows


def n_chunks(rows: int, chunk_size: int) -> int:
    """How many chunks a side of ``rows`` rows takes: ``max(1, rows //
    chunk_size)``, each ``rows // n`` rows. Raises where they do not divide."""
    if chunk_size < 1:
        raise ValueError(f"grad_cache: chunk size must be >= 1, got {chunk_size}")
    n = max(1, rows // chunk_size)
    if rows % n:
        raise ValueError(f"grad_cache: batch of {rows} rows is not divisible into {n} chunks "
                         f"(chunk size {chunk_size})")
    return n


def _chunks(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    size = batch["input_ids"].shape[0] // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n)]


def encode_chunks(model, side: str, chunks) -> torch.Tensor:
    """Pass 1: the chunks' reps [rows, D], joined, with no graph. Under
    ``no_grad``, not ``inference_mode``: inference tensors could not become
    leaves of the loss's graph in pass 2."""
    lm, head = model._towers(side)
    with torch.no_grad():
        return torch.cat([model._reps(lm, head, c) for c in chunks])


def rep_grads(model, q_reps: torch.Tensor, p_reps: torch.Tensor):
    """Pass 2: (loss, dloss/dq_reps, dloss/dp_reps) of the full-batch loss."""
    q_reps.requires_grad_(True)
    p_reps.requires_grad_(True)
    with torch.enable_grad():
        loss, _ = model.loss(q_reps, p_reps)
        dq, dp = torch.autograd.grad(loss, (q_reps, p_reps))
    return loss.detach(), dq, dp


def backward_chunks(model, side: str, chunks, grads: torch.Tensor) -> None:
    """Pass 3: each chunk encoded with its graph and backpropagated from its
    rows of ``grads``; parameter ``.grad`` accumulates."""
    lm, head = model._towers(side)
    for chunk, g in zip(chunks, grads.split(chunks[0]["input_ids"].shape[0])):
        model._reps(lm, head, chunk).backward(g)


def grad_cache_backward(model, query, passage, q_chunk_size: int, p_chunk_size: int,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The three passes over one (query, passage) batch. Accumulates the
    full-batch loss's gradient into the parameters' ``.grad`` (zero them
    before) and returns the loss, a device scalar.

    On a ``mesh`` the batch is this rank's block: pass 2 runs the global loss
    over every rank's reps (gathered without a graph) and pass 3 this rank's
    rows of its gradient, so each rank's ``.grad`` holds its own rows' share
    and the caller sums them over the ranks (``all_reduce_grads``)."""
    q = model._batch(query)
    p = model._batch(passage)
    # the ids go to the device once: pass 3 reuses pass 1's chunks, which are views
    # of these (32,768 passages x 128 int64 ids are 34 MB)
    q_chunks = _chunks(q, n_chunks(q["input_ids"].shape[0], q_chunk_size))
    p_chunks = _chunks(p, n_chunks(p["input_ids"].shape[0], p_chunk_size))
    q_reps = encode_chunks(model, "query", q_chunks)
    p_reps = encode_chunks(model, "passage", p_chunks)
    if mesh is None:
        loss, dq, dp = rep_grads(model, q_reps, p_reps)
    else:
        nq, np_, r = q_reps.shape[0], p_reps.shape[0], mesh.rank
        loss, dq, dp = rep_grads(model, gather_rows(q_reps, mesh), gather_rows(p_reps, mesh))
        dq, dp = dq[r * nq:(r + 1) * nq], dp[r * np_:(r + 1) * np_]
    backward_chunks(model, "query", q_chunks, dq)
    backward_chunks(model, "passage", p_chunks, dp)
    return loss

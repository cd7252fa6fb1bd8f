"""Fused in-batch contrastive loss: kernels K3 (forward) and K4 (backward).

Counterpart of ``denseretrievaltoolkits_tpu/ops/contrastive.py``: the softmax
CE over q·pᵀ with stride targets (query r's positive is passage r·stride),
computed without the [Q, P] score matrix.

- :func:`contrastive_fwd` (K3, ``csrc/contrastive.cu``): per query row the
  log-sum-exp of its scores and its target score. Plain version:
  :func:`_reference_contrastive_fwd`. At H % 64 == 0 with 16-byte aligned
  rows the products run on the tensor cores as fp16 pairs (a CTA a 128-row
  query tile, the passages in 128-row tiles by TMA, an online log-sum-exp in
  registers, the passage axis split across CTAs and merged in part order).
- :func:`contrastive_bwd_dq` / :func:`contrastive_bwd_dp` (K4, the same
  source): dq = g·p and dp = gᵀ·q with g = (exp(s − lse) − onehot)/n_q
  recomputed per tile, times the upstream scalar. Plain version:
  :func:`_reference_contrastive_bwd`, the closed form on a materialized [Q, P].
  At H = 768 with 16-byte aligned rows the products run on the tensor cores
  as fp16 pairs (a cluster of four CTAs a 64-row tile, one quarter of H
  each).
- Shapes a tensor-core body does not take run the same source's FFMA body,
  counted on ``<wrapper>.launches_generic`` too. ``<wrapper>.last_body`` names the
  body of the last call ("wgmma" or "ffma").
- :func:`fused_contrastive_loss`: the differentiable loss, K3 forward (saving
  lse) and K4 backward. :func:`contrastive_loss_auto` takes it when P % Q == 0
  and the plain loss with scores otherwise (contrastive.py:260-271).

A wrapper runs its plain version for tensors on the CPU. For CUDA tensors it
launches its kernel or raises; it never falls back. Launches are counted in
``<wrapper>.launches``. The kernels take fp32 (the FFMA bodies' products in
true fp32, the tensor-core bodies' as fp16 hi / lo pairs, ``csrc/split.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..train.losses import contrastive_loss
from . import _native


def _reference_contrastive_fwd(q, p, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3: (lse [Q], tgt [Q]) from the fp32 score matrix."""
    s = torch.matmul(q.float(), p.float().T)
    rows = torch.arange(q.shape[0], device=q.device)
    return torch.logsumexp(s, dim=1), s[rows, rows * stride]


def _reference_contrastive_bwd(q, p, lse, stride: int, gout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: (dq [Q,H], dp [P,H]) from g = (exp(s − lse) − onehot)/n_q."""
    q, p = q.float(), p.float()
    n_q = q.shape[0]
    rows = torch.arange(n_q, device=q.device)
    g = torch.exp(torch.matmul(q, p.T) - lse[:, None])
    g[rows, rows * stride] -= 1.0
    g = g / n_q
    return torch.matmul(g, p) * gout, torch.matmul(g.T, q) * gout


def _check(name, q, p, *extra):
    """What the kernels take; raise on anything else."""
    for t in (q, p) + extra:
        if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be a contiguous float32 tensor on "
                             f"{q.device}; got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    H = q.shape[1]
    if q.dim() != 2 or p.dim() != 2 or p.shape[1] != H:
        raise ValueError(f"{name}: q {tuple(q.shape)} and p {tuple(p.shape)} must be [Q, H], [P, H]")
    max_h = _native.library().drt_contrastive_max_h()
    if H % 4 or H > max_h or (q.data_ptr() | p.data_ptr()) % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned rows of H % 4 == 0 floats, "
                         f"H <= {max_h} (rows resident in shared memory); got H={H}")


def contrastive_fwd(q: torch.Tensor, p: torch.Tensor, stride: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (lse [Q], tgt [Q]) fp32 for q [Q,H], p [P,H]; the target of row r
    is column r·stride. The tensor-core body where the C entry takes the shape
    (it reports which body ran), with the scratch it asks for: the operands'
    largest magnitudes, both sides' fp16 planes ((Q + P) x H x 4 bytes) and,
    where the walked axis is split across CTAs, each part's row partials."""
    if not q.is_cuda:
        return _reference_contrastive_fwd(q, p, stride)
    _check("contrastive_fwd", q, p)
    lib = _native.library()
    Q, H = q.shape
    lse = torch.empty(Q, dtype=torch.float32, device=q.device)
    tgt = torch.empty_like(lse)
    n_scratch = lib.drt_contrastive_fwd_scratch_bytes(Q, p.shape[0], H)
    if n_scratch < 0:  # the card's SM count could not be read
        _native.check(-n_scratch, "drt_contrastive_fwd_scratch_bytes")
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=q.device) if n_scratch else None
    body = ctypes.c_int(0)
    contrastive_fwd.launches += 1
    _native.check(lib.drt_contrastive_fwd(
        q.data_ptr(), p.data_ptr(), lse.data_ptr(), tgt.data_ptr(), Q, p.shape[0], H, stride,
        0 if scratch is None else scratch.data_ptr(), ctypes.byref(body), _native.stream_ptr(q)),
        "drt_contrastive_fwd")
    contrastive_fwd.last_body = "wgmma" if body.value else "ffma"
    if not body.value:
        contrastive_fwd.launches_generic += 1
    return lse, tgt


contrastive_fwd.launches = 0
contrastive_fwd.launches_generic = 0
contrastive_fwd.last_body = None


def _bwd(wrapper, entry, q, p, lse, stride, gout, rows):
    """Launch a K4 entry: the tensor-core body where the C entry takes the shape
    (it reports which body ran), with the scratch it asks for: the operands'
    largest magnitudes, the walked side's fp16 planes (its rows x H x 4 bytes)
    and, where the walked axis is split across clusters, the parts' sums."""
    _check(wrapper.__name__, q, p, lse, gout)
    if lse.shape != (q.shape[0],) or gout.numel() != 1:
        raise ValueError(f"{wrapper.__name__}: lse must be [Q] and gout a scalar")
    lib = _native.library()
    Q, H = q.shape
    out = torch.empty(rows, H, dtype=torch.float32, device=q.device)
    n_scratch = lib.drt_contrastive_scratch_bytes(Q, p.shape[0], H,
                                                  int(entry == "drt_contrastive_dp"))
    if n_scratch < 0:  # the card's cluster occupancy could not be read
        _native.check(-n_scratch, "drt_contrastive_scratch_bytes")
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=q.device) if n_scratch else None
    body = ctypes.c_int(0)
    wrapper.launches += 1
    _native.check(getattr(lib, entry)(
        q.data_ptr(), p.data_ptr(), lse.data_ptr(), gout.data_ptr(), out.data_ptr(), Q,
        p.shape[0], H, stride, 0 if scratch is None else scratch.data_ptr(), ctypes.byref(body),
        _native.stream_ptr(q)), entry)
    wrapper.last_body = "wgmma" if body.value else "ffma"
    if not body.value:
        wrapper.launches_generic += 1
    return out


def contrastive_bwd_dq(q, p, lse, stride: int, gout) -> torch.Tensor:
    """K4, dq body: gout · g·p, [Q, H] fp32. ``gout`` is the upstream scalar
    gradient as a one-element tensor (read on the device: no host sync)."""
    if not q.is_cuda:
        return _reference_contrastive_bwd(q, p, lse, stride, gout)[0]
    return _bwd(contrastive_bwd_dq, "drt_contrastive_dq", q, p, lse, stride,
                gout.float().reshape(1).contiguous(), q.shape[0])


contrastive_bwd_dq.launches = 0
contrastive_bwd_dq.launches_generic = 0
contrastive_bwd_dq.last_body = None


def contrastive_bwd_dp(q, p, lse, stride: int, gout) -> torch.Tensor:
    """K4, dp body: gout · gᵀ·q, [P, H] fp32."""
    if not q.is_cuda:
        return _reference_contrastive_bwd(q, p, lse, stride, gout)[1]
    return _bwd(contrastive_bwd_dp, "drt_contrastive_dp", q, p, lse, stride,
                gout.float().reshape(1).contiguous(), p.shape[0])


contrastive_bwd_dp.launches = 0
contrastive_bwd_dp.launches_generic = 0
contrastive_bwd_dp.last_body = None


class _FusedContrastiveLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, p, stride):
        lse, tgt = contrastive_fwd(q, p, stride)
        ctx.stride = stride
        ctx.save_for_backward(q, p, lse)
        return (lse - tgt).sum() / q.shape[0]

    @staticmethod
    def backward(ctx, g):
        q, p, lse = ctx.saved_tensors
        dq = contrastive_bwd_dq(q, p, lse, ctx.stride, g) if ctx.needs_input_grad[0] else None
        dp = contrastive_bwd_dp(q, p, lse, ctx.stride, g) if ctx.needs_input_grad[1] else None
        return dq, dp, None


def fused_contrastive_loss(q_reps: torch.Tensor, p_reps: torch.Tensor,
                           stride: int) -> torch.Tensor:
    """Mean in-batch softmax CE, query r's target passage r·stride, as one
    differentiable scalar: K3 forward (lse saved), K4 backward."""
    Q, P = q_reps.shape[0], p_reps.shape[0]
    if stride < 1 or (Q - 1) * stride >= P:
        raise ValueError(f"fused_contrastive_loss: target column (Q-1)*stride = "
                         f"{(Q - 1) * stride} is outside P={P}")
    return _FusedContrastiveLoss.apply(q_reps.float().contiguous(), p_reps.float().contiguous(),
                                       stride)


def contrastive_loss_auto(q_reps, p_reps) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fused loss when targets are stride-form (P % Q == 0), else the plain
    one. Returns (loss, scores); scores are None on the fused path."""
    Q, P = q_reps.shape[0], p_reps.shape[0]
    if P % Q == 0:
        return fused_contrastive_loss(q_reps, p_reps, P // Q), None
    return contrastive_loss(q_reps, p_reps)

"""Contrastive and pairwise ranking losses, plain PyTorch.

Counterpart of ``denseretrievaltoolkits_tpu/train/losses.py``:

- :func:`stride_targets` and :func:`contrastive_loss`: in-batch softmax CE
  over the fp32 q·pᵀ score matrix with stride targets (losses.py:23-45). The
  fused kernel form, which never builds the score matrix, is
  ``ops/contrastive.py``.
- the reranker pairwise losses mr / smr / bce / ce (losses.py:53-82).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def stride_targets(num_queries: int, num_passages: int, device=None) -> torch.Tensor:
    """Query i's positive is passage i * (P // Q)."""
    stride = num_passages // num_queries
    return torch.arange(num_queries, device=device) * stride


def contrastive_loss(q_reps: torch.Tensor, p_reps: torch.Tensor,
                     targets: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch softmax CE over the q·pᵀ score matrix. Returns (loss, scores)."""
    scores = torch.matmul(q_reps.float(), p_reps.float().T)
    if targets is None:
        targets = stride_targets(q_reps.shape[0], p_reps.shape[0], device=scores.device)
    return F.cross_entropy(scores, targets), scores


def margin_ranking_loss(pos_scores, neg_scores, margin: float = 1.0):
    return torch.relu(margin - pos_scores + neg_scores).mean()


def soft_margin_ranking_loss(pos_scores, neg_scores, margin: float = 1.0):
    return F.softplus(margin - pos_scores + neg_scores).mean()


def binary_cross_entropy_loss(pos_scores, neg_scores, margin: float = 1.0):
    pos = F.binary_cross_entropy_with_logits(pos_scores, torch.ones_like(pos_scores))
    neg = F.binary_cross_entropy_with_logits(neg_scores, torch.zeros_like(neg_scores))
    return pos + neg


def cross_entropy_loss(pos_scores, neg_scores, margin: float = 1.0):
    """CE over 2-way [neg_logit, pos_logit] scores (T5 token-scoring reranker)."""
    pos_t = torch.ones(pos_scores.shape[0], dtype=torch.long, device=pos_scores.device)
    neg_t = torch.zeros(neg_scores.shape[0], dtype=torch.long, device=neg_scores.device)
    return F.cross_entropy(pos_scores, pos_t) + F.cross_entropy(neg_scores, neg_t)


rr_loss_functions = {
    "mr": margin_ranking_loss,
    "smr": soft_margin_ranking_loss,
    "bce": binary_cross_entropy_loss,
    "ce": cross_entropy_loss,
}

"""Pooling and normalization over encoder hidden states.

Counterpart of ``denseretrievaltoolkits_tpu/models/pooling.py``: CLS /
masked-mean / masked-max pooling and optional L2 normalization.
"""

from __future__ import annotations

import torch


def pool(hidden: torch.Tensor, attention_mask: torch.Tensor, method: str = "first") -> torch.Tensor:
    """Pool [B, S, H] hidden states to [B, H]."""
    if method == "first":
        return hidden[:, 0, :]
    mask = attention_mask.to(hidden.dtype)[:, :, None]
    if method == "mean":
        summed = (hidden * mask).sum(dim=1)
        count = mask.sum(dim=1).clamp(min=1e-9)
        return summed / count
    if method == "max":
        # multiply by the mask, as the reference does, rather than -inf masking
        return (hidden * mask).amax(dim=1)
    raise ValueError(f"Unknown pooling type: {method}")


def l2_normalize(reps: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return reps / torch.linalg.vector_norm(reps, dim=-1, keepdim=True).clamp(min=eps)

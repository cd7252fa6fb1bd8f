"""Bias-free linear projection head.

Counterpart of ``denseretrievaltoolkits_tpu/models/linear.py``: one no-bias
projection, ``[in, out]`` kernel, read from the reference's ``linear.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

HEAD_WEIGHTS = "linear.npz"


class LinearHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim, device=device),
                                   requires_grad=False)

    def forward(self, reps: torch.Tensor) -> torch.Tensor:
        return torch.matmul(reps, self.kernel.to(reps.dtype))


def load_head(ckpt_dir: str, device=None) -> LinearHead:
    with np.load(os.path.join(ckpt_dir, HEAD_WEIGHTS)) as z:
        kernel = torch.from_numpy(np.asarray(z["kernel"], np.float32))
    head = LinearHead(*kernel.shape, device=device)
    head.kernel.copy_(kernel)
    return head

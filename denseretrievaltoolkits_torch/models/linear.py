"""Bias-free linear projection head.

Counterpart of ``denseretrievaltoolkits_tpu/models/linear.py``: one no-bias
projection, ``[in, out]`` kernel, kept in fp32 and cast to the reps' dtype at
use; saved and read as the reference's ``linear.npz`` + ``head_config.json``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

HEAD_WEIGHTS = "linear.npz"
HEAD_CONFIG = "head_config.json"


class LinearHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim, device=device))

    def forward(self, reps: torch.Tensor) -> torch.Tensor:
        return torch.matmul(reps, self.kernel.to(reps.dtype))


def init_head(in_dim: int, out_dim: int, seed) -> LinearHead:
    """Random init as ``linear.init_head`` (linear.py:21-23): N(0, 1) x
    ``in_dim ** -0.5``, drawn with numpy from ``seed`` (an int or a sequence
    of ints for ``np.random.default_rng``)."""
    rng = np.random.default_rng(seed)
    kernel = rng.standard_normal((in_dim, out_dim), dtype=np.float32) * np.float32(in_dim ** -0.5)
    head = LinearHead(in_dim, out_dim)
    with torch.no_grad():
        head.kernel.copy_(torch.from_numpy(kernel))
    return head


def save_head(head: LinearHead, ckpt_dir: str) -> None:
    """Write the reference's layout (``linear.save_head``, linear.py:31-36)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    kernel = head.kernel.detach().float().cpu().numpy()
    np.savez(os.path.join(ckpt_dir, HEAD_WEIGHTS), kernel=kernel)
    with open(os.path.join(ckpt_dir, HEAD_CONFIG), "w") as fh:
        json.dump({"input_dim": int(kernel.shape[0]), "output_dim": int(kernel.shape[1])}, fh,
                  indent=4)


def load_head(ckpt_dir: str, device=None) -> LinearHead:
    with np.load(os.path.join(ckpt_dir, HEAD_WEIGHTS)) as z:
        kernel = torch.from_numpy(np.asarray(z["kernel"], np.float32))
    head = LinearHead(*kernel.shape, device=device)
    with torch.no_grad():
        head.kernel.copy_(kernel)
    return head

"""Runtime setup shared by the entry points (``denseretrievaltoolkits_tpu/utils/runtime.py``).

The JAX package's persistent XLA compilation cache has no counterpart here:
the kernels are built once per checkout, at first use, into ``_build/``
(``ops/_native.py``). Under ``torchrun`` (``WORLD_SIZE`` > 1) the process
group starts here (``utils/distributed.py``), and the entry points build a
mesh over it.
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from .distributed import local_device, maybe_initialize_distributed


def setup_runtime(device=None) -> torch.device:
    """The device an entry point runs on, resolved before any data is
    tokenized: the CUDA card unless ``device`` names another
    (``cuda:LOCAL_RANK`` under ``torchrun``); without a card this raises.
    When ``WORLD_SIZE`` > 1 and no process group is started yet, one starts
    (nccl for CUDA, gloo for the CPU); a caller that wants another backend
    starts its group first. fp32 products stay in true fp32
    (PyTorch's default ``"highest"`` matmul precision), which the plain
    versions' numerics assume."""
    if device is None and "LOCAL_RANK" in os.environ:
        device = local_device()
    device = resolve_device(device, "the entry point")
    torch.set_float32_matmul_precision("highest")
    maybe_initialize_distributed(device=device)
    return device

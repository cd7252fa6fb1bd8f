"""Runtime setup shared by the entry points (``denseretrievaltoolkits_tpu/utils/runtime.py``).

The JAX package's persistent XLA compilation cache has no counterpart here:
the kernels are built once per checkout, at first use, into ``_build/``
(``ops/_native.py``). Process-group initialization waits for ROADMAP queue 1,
item '`parallel/` and `utils/distributed.py`'.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def setup_runtime(device=None) -> torch.device:
    """The device an entry point runs on, resolved before any data is
    tokenized: the CUDA card unless ``device`` names another; without a card
    this raises. fp32 products stay in true fp32 (PyTorch's default
    ``"highest"`` matmul precision), which the plain versions' numerics
    assume."""
    device = resolve_device(device, "the entry point")
    torch.set_float32_matmul_precision("highest")
    return device

"""Where the port's entry points run: on the CUDA card unless the caller names
another device. Nothing falls back to the CPU by itself."""

from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``, CUDA when it is None. Raises a
    ``RuntimeError`` naming ``what`` when CUDA is asked for and no card is
    present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on a CUDA card and none is present "
                           f"(torch.cuda.is_available() is false); pass device='cpu' to run "
                           f"on the CPU")
    return device

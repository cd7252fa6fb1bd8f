"""Precision of the reference's matrix products.

``exact`` keeps float32 (TF32 off: :func:`strict_fp32`). ``fp8`` rounds every operand of
a product to float8 e4m3 under a per-tensor scale (absmax to 448), the step below the
configurations' bfloat16 that a later change could be tempted by. It is the control: it
has to come out as not correct. Gradients pass the rounding unchanged (straight
through), as in fp8 training.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """float32 products in float32 on the card: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
        q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


CASTS = {"exact": exact, "fp8": fp8}

"""Per-row symmetric int8 quantization (K7) and its inverse.

Counterpart of ``denseretrievaltoolkits_tpu/ops/quant.py:20-61`` and of
``quantize_queries`` (``ops/topk.py:539-547``):

- :func:`quantize_int8_device` (K7, ``csrc/quant.cu``): reps [N, H] fp32 or
  bf16 -> (values [rows, H] int8, scales [rows] fp32), scale = absmax / 127
  (1 for a zero row), values = clip(round(x / scale), -127, 127). ``rows`` >=
  N pads the output with zero rows of scale 1, as the reference pads a slab
  before quantizing it. Bit-equal to numpy's ``quantize_int8``
  (``index/flat.py``), so int8 payloads interchange with the JAX package. Its
  plain version is :func:`_quantize_int8_reference`. CPU tensors take the
  plain version; CUDA tensors launch the kernel or raise. Launches are counted
  in ``quantize_int8_device.launches``.
- :func:`quantize_queries`: the i8q path's query quantizer. It is the same
  per-row absmax / 127 map, so the port computes it with K7 itself.
- :func:`dequantize_int8`: values x scales, for parity checks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _native


def _quantize_int8_reference(reps: torch.Tensor, rows: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: IEEE fp32 divisions, round half to even."""
    x = reps.float()
    n = x.shape[0]
    rows = n if rows is None else rows
    scales = torch.ones(rows, dtype=torch.float32, device=x.device)
    values = torch.zeros((rows, x.shape[1]), dtype=torch.int8, device=x.device)
    absmax = x.abs().amax(dim=1)
    # a tensor divisor: PyTorch divides by a Python scalar as a multiply by its
    # reciprocal, which can miss the IEEE quotient by an ulp
    scale = absmax / torch.full_like(absmax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    scales[:n] = scale
    values[:n] = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return values, scales


def quantize_int8_device(reps: torch.Tensor, rows: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize reps [N, H] (fp32 or bf16) per row to int8 (K7). Returns
    (values [rows, H] int8, scales [rows] fp32); ``rows`` (default N) pads."""
    if reps.ndim != 2:
        raise ValueError(f"quantize_int8_device: expected [N, H] reps, got {tuple(reps.shape)}")
    N, H = reps.shape
    rows = N if rows is None else int(rows)
    if rows < N:
        raise ValueError(f"quantize_int8_device: rows={rows} < N={N}")
    if not reps.is_cuda:
        return _quantize_int8_reference(reps, rows)
    if reps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_int8_device: the CUDA kernel takes float32 or bfloat16 "
                        f"reps, got {reps.dtype}")
    reps = reps.contiguous()
    values = torch.empty((rows, H), dtype=torch.int8, device=reps.device)
    scales = torch.empty(rows, dtype=torch.float32, device=reps.device)
    if rows == 0:
        return values, scales
    lib = _native.library()
    quantize_int8_device.launches += 1
    _native.check(lib.drt_quantize_int8(
        reps.data_ptr(), values.data_ptr(), scales.data_ptr(), N, rows, H,
        int(reps.dtype == torch.bfloat16), _native.stream_ptr(reps)), "drt_quantize_int8")
    return values, scales


quantize_int8_device.launches = 0


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 queries for the i8q search: (q_int8 [Q, H], scales [Q] fp32), zero
    rows at scale 1. The reference's ``quantize_queries`` is K7's map, so this
    is K7."""
    return quantize_int8_device(q.float())


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """values [N, H] int8, scales [N] -> fp32 reps."""
    return values.float() * scales[:, None]

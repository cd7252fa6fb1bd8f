"""Per-row symmetric int8 (K7) and int4 (K9) quantization and their inverses.

Counterpart of ``denseretrievaltoolkits_tpu/ops/quant.py`` and of
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
- :func:`quantize_int4_device` (K9, ``csrc/quant.cu``): reps [N, H] (H even)
  -> (packed [rows, H/2] int8, scales [rows] fp32), scale = absmax / 7,
  codes = clip(round(x / scale), -7, 7), byte j holding code j in its low
  nibble and code j + H/2 in its high nibble (the reference's column-half
  layout, quant.py:64-76). The same IEEE divisions and half-to-even rounding
  as K7; padding rows are zero bytes at scale 1. Plain version
  :func:`_quantize_int4_reference`; launches in
  ``quantize_int4_device.launches``.
- :func:`unpack_int4` / :func:`dequantize_int4`: the sign-extended codes in
  dim order, and codes x scales.
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


def _quantize_int4_reference(reps: torch.Tensor, rows: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: K7's divisions and rounding at absmax / 7, codes
    packed in column halves."""
    x = reps.float()
    n, H = x.shape
    half = H // 2
    rows = n if rows is None else rows
    scales = torch.ones(rows, dtype=torch.float32, device=x.device)
    packed = torch.zeros((rows, half), dtype=torch.int8, device=x.device)
    absmax = x.abs().amax(dim=1)
    scale = absmax / torch.full_like(absmax, 7.0)  # a tensor divisor, as K7's
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    scales[:n] = scale
    codes = torch.clamp(torch.round(x / scale[:, None]), -7, 7).to(torch.int32)
    byte = (codes[:, :half] & 0xF) | ((codes[:, half:] & 0xF) << 4)
    packed[:n] = torch.where(byte > 127, byte - 256, byte).to(torch.int8)
    return packed, scales


def _quantize(wrapper, kernel, plain, width, reps, rows):
    """Check the operands, then quantize ``reps`` per row with ``plain`` (CPU
    tensors) or by launching ``kernel`` (CUDA), which adds one to
    ``wrapper.launches``. Returns (values [rows, width], scales [rows])."""
    name = wrapper.__name__
    if reps.ndim != 2:
        raise ValueError(f"{name}: expected [N, H] reps, got {tuple(reps.shape)}")
    N, H = reps.shape
    rows = N if rows is None else int(rows)
    if rows < N:
        raise ValueError(f"{name}: rows={rows} < N={N}")
    if not reps.is_cuda:
        return plain(reps, rows)
    if reps.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16 reps, got "
                        f"{reps.dtype}")
    reps = reps.contiguous()
    values = torch.empty((rows, width), dtype=torch.int8, device=reps.device)
    scales = torch.empty(rows, dtype=torch.float32, device=reps.device)
    if rows == 0:
        return values, scales
    lib = _native.library()
    wrapper.launches += 1
    _native.check(getattr(lib, kernel)(
        reps.data_ptr(), values.data_ptr(), scales.data_ptr(), N, rows, H,
        int(reps.dtype == torch.bfloat16), _native.stream_ptr(reps)), kernel)
    return values, scales


def quantize_int8_device(reps: torch.Tensor, rows: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize reps [N, H] (fp32 or bf16) per row to int8 (K7). Returns
    (values [rows, H] int8, scales [rows] fp32); ``rows`` (default N) pads."""
    return _quantize(quantize_int8_device, "drt_quantize_int8", _quantize_int8_reference,
                     reps.shape[-1], reps, rows)


quantize_int8_device.launches = 0


def quantize_int4_device(reps: torch.Tensor, rows: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize reps [N, H] (fp32 or bf16, H even) per row to nibble-packed
    int4 (K9). Returns (packed [rows, H/2] int8, scales [rows] fp32); ``rows``
    (default N) pads."""
    if reps.shape[-1] % 2:
        raise ValueError(f"quantize_int4_device: int4 packing needs an even feature dim, got "
                         f"{reps.shape[-1]}")
    return _quantize(quantize_int4_device, "drt_quantize_int4", _quantize_int4_reference,
                     reps.shape[-1] // 2, reps, rows)


quantize_int4_device.launches = 0


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 queries for the i8q search: (q_int8 [Q, H], scales [Q] fp32), zero
    rows at scale 1. The reference's ``quantize_queries`` is K7's map, so this
    is K7."""
    return quantize_int8_device(q.float())


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """values [N, H] int8, scales [N] -> fp32 reps."""
    return values.float() * scales[:, None]


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed [N, H/2] int8 -> the codes [N, H] int8 in dim order: the low
    nibbles (dims 0 .. H/2-1), then the high nibbles, each sign-extended (an
    arithmetic right shift of the int8 byte, the low nibble first shifted up)."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    return torch.cat([lo, hi], dim=1)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """packed [N, H/2] int8, scales [N] -> fp32 reps [N, H]."""
    return unpack_int4(packed).float() * scales[:, None]

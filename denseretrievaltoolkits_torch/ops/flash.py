"""Flash attention over segment ids: forward and backward kernels, with their plain versions.

Counterpart of ``denseretrievaltoolkits_tpu/models/bert.py:_flash_attention``, which
calls the stock Pallas flash attention (``jax.experimental.pallas.ops.tpu.
flash_attention``) with the 0/1 attention mask as segment ids: key j is visible to
query i iff ``seg[i] == seg[j]``. Real rows see the real keys; pad rows see the pad
keys (every row sees itself, so none is empty).

- :func:`flash_fwd` (``csrc/flash_attn.cu``, replacing the stock
  ``_flash_attention_kernel``): ``(o, lse)``, the output and the fp32 log-sum-exp of
  each row's scaled, masked scores. Plain version: :func:`_reference_flash_fwd`.
- :func:`flash_bwd_dq` (the stock ``_flash_attention_dq_kernel``), launched first,
  and :func:`flash_bwd_dkv` (``_flash_attention_dkv_kernel``): dQ and dK/dV from P
  recomputed off the saved lse. The dQ kernel also computes ``D = rowsum(dO * O)``
  by the stock VJP's formula (flash_attention.py:273-275, which runs it outside its
  kernels) for its rows, uses it and returns it for the dK/dV kernel. Plain
  versions: :func:`_reference_flash_d`, :func:`_reference_flash_bwd_dkv`,
  :func:`_reference_flash_bwd_dq`, the same closed forms on the materialized
  scores.
- :func:`flash_attention_qkv`: the differentiable attention over the ``[B, S, 3H]``
  QKV projection, read in place: the forward kernel saves O and the lse, and both
  backward kernels write dq, dk and dv into the one ``[B, S, 3, nh, hd]`` gradient of
  the projection. :func:`flash_attention` takes the reference's ``[B, S, nh, hd]``
  q, k and v and joins them for it.

The kernel wrappers take q, k and v as ``[B, S, nh, hd]``, possibly strided views
of the QKV projection (heads contiguous, last dim contiguous). The reference pads S
to a multiple of 128 with segment id 0, so its pad queries also average the zero
padding keys: real rows agree with this module, pad rows differ but stay finite
(nothing reads them).

A wrapper runs its plain version for tensors on the CPU. For CUDA tensors it launches
its kernel or raises; it never falls back. Launches are counted in
``<wrapper>.launches``. The kernels take float32 (head dim a multiple of 8) and
bfloat16 (a multiple of 16, 16-byte aligned rows), head dim at most 128. The forward
kernel has a body per case, fixed by dtype and head dim: bf16 at hd 64 and 128 on
Hopper's wgmma with the streamed operands by TMA, bf16 at other head dims on
mma.sync, fp32 on FFMA; so do the backward kernels (wgmma at bf16 hd 64 and 128).
The forward's wgmma and fp32 bodies and both backward wgmma bodies skip the (query
tile, key tile) pairs that :func:`_visible_tiles` leaves out, which changes no
output.

Numerics of the plain versions (and the kernels): fp32 scores scaled by sm_scale,
fp32 softmax, probabilities cast to the compute dtype before p·v, which accumulates
in fp32; the backward casts P and dS (scaled) to the compute dtype before their
products, as the stock kernels do.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _native

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128


def split_qkv(qkv, nh: int, hd: int):
    """The q, k and v of a [B, S, 3H] QKV projection ([q | k | v], heads
    contiguous) as three [B, S, nh, hd] views, which the kernels read in place."""
    B, S, _ = qkv.shape
    H = nh * hd
    return tuple(qkv[..., i * H:(i + 1) * H].view(B, S, nh, hd) for i in range(3))


def _scores(q, k, seg, sm_scale):
    """fp32 scaled scores [B, nh, S, S], -inf where the segments differ."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return s.masked_fill(~same, float("-inf"))


def _tile_values(mask, bt):
    """Per tile of ``bt`` rows, whether a row below S holds 0, holds 1, holds any
    other value: three bool [B, ceil(S / bt)]."""
    B, S = mask.shape
    n = -(-S // bt)
    m = torch.nn.functional.pad(mask.long(), (0, n * bt - S), value=0).view(B, n, bt)
    real = torch.nn.functional.pad(torch.ones_like(mask, dtype=torch.bool), (0, n * bt - S),
                                   value=False).view(B, n, bt)
    return ((m == 0) & real).any(-1), ((m == 1) & real).any(-1), ((m != 0) & (m != 1) & real).any(-1)


def _visible_tiles(mask, bm: int, bn: int, bias: bool) -> torch.Tensor:
    """Which (row tile, column tile) pairs the kernels visit: bool [B, ceil(S / bm),
    ceil(S / bn)], the rule ``csrc/flash_attn.cu`` implements. The forward and the
    dQ kernel take query tiles of bm rows against key tiles of bn; the dK/dV kernel
    takes key tiles of bm rows against query tiles of bn (segment mode is symmetric:
    the result is the transpose of the call with bm and bn swapped).

    Segment mode: the tiles' sets of mask values (rows below S) intersect, two
    tiles holding values other than 0 and 1 counting as intersecting. Bias mode:
    the key tile holds a key whose mask is not 0, or the sequence holds no key of
    mask 1. Every pair left out is all -inf in :func:`_scores` (segment mode) or,
    in bias mode, all keys biased -1e9 in a row that sees a key biased 0, whose
    exp(s - m) is exactly 0 in fp32: skipping them changes no output."""
    kz, ko, kx = _tile_values(mask, bn)
    if bias:
        vis = ko | kx | ~ko.any(-1, keepdim=True)
        return vis[:, None, :].expand(-1, -(-mask.shape[1] // bm), -1).clone()
    qz, qo, qx = _tile_values(mask, bm)
    return ((qz[:, :, None] & kz[:, None, :]) | (qo[:, :, None] & ko[:, None, :])
            | (qx[:, :, None] & kx[:, None, :]))


def _reference_flash_fwd(q, k, v, seg, sm_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (o [B,S,nh,hd] in q's dtype, lse [B,nh,S] fp32)."""
    s = _scores(q, k, seg, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    return o.contiguous(), lse


def _reference_flash_attention(q, k, v, seg, hd):
    """Plain flash attention, [B,S,nh,hd] -> [B,S,nh,hd]; differentiable by autograd."""
    return _reference_flash_fwd(q, k, v, seg, 1.0 / math.sqrt(hd))[0]


def _probs_and_ds(q, k, v, seg, lse, do, D, sm_scale):
    """P = exp(s - lse) and dS = P * (dO·Vᵀ - D) * sm_scale, both fp32 [B,nh,S,S]."""
    p = torch.exp(_scores(q, k, seg, sm_scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - D[..., None]) * sm_scale


def _reference_flash_d(o, do):
    """D = rowsum(dO * O) in fp32, [B, nh, S]: the stock VJP's formula
    (flash_attention.py:273-275) on [B, S, nh, hd] o and dO."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _reference_flash_bwd_dkv(q, k, v, seg, lse, do, D, sm_scale):
    """Plain dK/dV: dV = Pᵀ·dO, dK = dSᵀ·Q, P and dS cast to the compute dtype first."""
    p, ds = _probs_and_ds(q, k, v, seg, lse, do, D, sm_scale)
    dt = q.dtype
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float())
    return dk.to(dt), dv.to(dt)


def _reference_flash_bwd_dq(q, k, v, seg, lse, do, D, sm_scale):
    """Plain dQ = dS·K, dS cast to the compute dtype first."""
    _, ds = _probs_and_ds(q, k, v, seg, lse, do, D, sm_scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), k.float()).to(q.dtype)


def _check_qkv(name, q, k, v, mask):
    """What the kernels take; raise on anything else. Returns the int32 mask."""
    dev = q.device
    for t in (k, v, mask):
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}; got one on {t.device}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: the CUDA kernels take float32 or bfloat16 q, k and v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must be [B, S, nh, hd] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, nh, hd = q.shape
    if mask.shape != (B, S):
        raise ValueError(f"{name}: the mask must be [B, S] = {(B, S)}; got {tuple(mask.shape)}")
    multiple = 16 if q.dtype == torch.bfloat16 else 8
    if hd % multiple or hd > MAX_HEAD_DIM or B > 65535 or nh > 65535 or B * S == 0:
        raise ValueError(f"{name}: the {q.dtype} kernels take a head dim that is a multiple of "
                         f"{multiple} and at most {MAX_HEAD_DIM}; got hd={hd} (B={B}, S={S}, "
                         f"nh={nh})")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides or strides[3] != 1 or strides[2] != hd:
        raise ValueError(f"{name}: q, k and v must share strides with contiguous heads "
                         f"(stride[2] == hd, stride[3] == 1); got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    if q.dtype == torch.bfloat16 and (any(t.data_ptr() % 16 for t in (q, k, v))
                                      or strides[0] % 8 or strides[1] % 8):
        raise ValueError(f"{name}: the bf16 kernels read 16-byte aligned rows; got strides "
                         f"{strides}")
    return mask.to(torch.int32).contiguous()


def _launch_fwd(wrapper, q, k, v, mask, sm_scale, bias: bool, with_lse: bool):
    """Launch the forward kernel (segment or bias mode); count it on ``wrapper``."""
    mask = _check_qkv(wrapper.__name__, q, k, v, mask)
    B, S, nh, hd = q.shape
    o = torch.empty(B, S, nh, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, nh, S, dtype=torch.float32, device=q.device) if with_lse else None
    lib = _native.library()
    wrapper.launches += 1
    _native.check(lib.drt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None, B, S, nh, hd, q.stride(0), q.stride(1),
        float(sm_scale), int(bias), int(q.dtype == torch.bfloat16), _native.stream_ptr(q)),
        "drt_flash_fwd")
    return o, lse


def flash_fwd(q, k, v, seg, sm_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o [B,S,nh,hd] contiguous, lse [B,nh,S] fp32)."""
    if not q.is_cuda:
        return _reference_flash_fwd(q, k, v, seg, sm_scale)
    return _launch_fwd(flash_fwd, q, k, v, seg, sm_scale, bias=False, with_lse=True)


flash_fwd.launches = 0


def _check_bwd(name, q, lse, do, dqkv, D=None, o=None):
    """lse (and D) contiguous [B, nh, S] fp32, dO (and O) contiguous [B, S, nh, hd] and
    dqkv a contiguous [B, S, 3, nh, hd] of q's dtype on q's device; bf16 dO and O
    16-byte aligned (the kernels read their rows by TMA or 16-byte loads)."""
    B, S, nh, hd = q.shape
    stats, rows = (B, nh, S), (B, S, nh, hd)
    for t, shape, dtype in ((lse, stats, torch.float32), (D, stats, torch.float32),
                            (do, rows, q.dtype), (o, rows, q.dtype),
                            (dqkv, (B, S, 3, nh, hd), q.dtype)):
        if t is None:
            continue
        if t.device != q.device or t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: lse and D must be contiguous [B, nh, S] float32, dO and O "
                             f"contiguous [B, S, nh, hd] and dqkv a contiguous [B, S, 3, nh, hd] "
                             f"{q.dtype} tensor on {q.device}; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (do, o) if t is not None):
        raise ValueError(f"{name}: the bf16 kernels read dO and O as 16-byte aligned rows")


def _slot(dqkv, which):
    """Pointer of slot ``which`` (0 dq, 1 dk, 2 dv) of the [B,S,3,nh,hd] gradient."""
    return dqkv.data_ptr() + which * dqkv.stride(2) * dqkv.element_size()


def flash_bwd_dkv(q, k, v, seg, lse, do, D, sm_scale, dqkv) -> None:
    """dK/dV kernel: writes them into ``dqkv[:, :, 1]`` and ``dqkv[:, :, 2]`` of the
    [B,S,3,nh,hd] gradient, which is laid out like the QKV projection. D is what
    :func:`flash_bwd_dq` returned."""
    if not q.is_cuda:
        dk, dv = _reference_flash_bwd_dkv(q, k, v, seg, lse, do, D, sm_scale)
        dqkv[:, :, 1].copy_(dk)
        dqkv[:, :, 2].copy_(dv)
        return
    mask = _check_qkv("flash_bwd_dkv", q, k, v, seg)
    _check_bwd("flash_bwd_dkv", q, lse, do, dqkv, D=D)
    B, S, nh, hd = q.shape
    lib = _native.library()
    flash_bwd_dkv.launches += 1
    _native.check(lib.drt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lse.data_ptr(), D.data_ptr(),
        do.data_ptr(), _slot(dqkv, 1), _slot(dqkv, 2), B, S, nh, hd, q.stride(0), q.stride(1),
        dqkv.stride(0), dqkv.stride(1), float(sm_scale), int(q.dtype == torch.bfloat16),
        _native.stream_ptr(q)), "drt_flash_bwd_dkv")


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, seg, lse, do, o, sm_scale, dqkv) -> torch.Tensor:
    """dQ kernel: writes it into ``dqkv[:, :, 0]`` of the [B,S,3,nh,hd] gradient, and
    returns D = rowsum(dO * O), [B, nh, S] fp32, which it computes first from the
    forward's output ``o`` and uses; :func:`flash_bwd_dkv` takes it."""
    if not q.is_cuda:
        D = _reference_flash_d(o, do)
        dqkv[:, :, 0].copy_(_reference_flash_bwd_dq(q, k, v, seg, lse, do, D, sm_scale))
        return D
    mask = _check_qkv("flash_bwd_dq", q, k, v, seg)
    _check_bwd("flash_bwd_dq", q, lse, do, dqkv, o=o)
    B, S, nh, hd = q.shape
    D = torch.empty(B, nh, S, dtype=torch.float32, device=q.device)
    lib = _native.library()
    flash_bwd_dq.launches += 1
    _native.check(lib.drt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lse.data_ptr(), o.data_ptr(),
        do.data_ptr(), D.data_ptr(), _slot(dqkv, 0), B, S, nh, hd, q.stride(0), q.stride(1),
        dqkv.stride(0), dqkv.stride(1), float(sm_scale), int(q.dtype == torch.bfloat16),
        _native.stream_ptr(q)), "drt_flash_bwd_dq")
    return D


flash_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Over the [B,S,3H] QKV projection, whose gradient is the one [B,S,3,nh,hd]
    tensor both backward kernels write."""

    @staticmethod
    def forward(ctx, qkv, seg, nh, hd):
        sm_scale = 1.0 / math.sqrt(hd)
        o, lse = flash_fwd(*split_qkv(qkv, nh, hd), seg, sm_scale)
        ctx.nh, ctx.hd, ctx.sm_scale = nh, hd, sm_scale
        ctx.save_for_backward(qkv, seg, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, seg, o, lse = ctx.saved_tensors
        q, k, v = split_qkv(qkv, ctx.nh, ctx.hd)
        do = do.contiguous()
        dqkv = torch.empty(*q.shape[:2], 3, *q.shape[2:], dtype=q.dtype, device=q.device)
        D = flash_bwd_dq(q, k, v, seg, lse, do, o, ctx.sm_scale, dqkv)
        flash_bwd_dkv(q, k, v, seg, lse, do, D, ctx.sm_scale, dqkv)
        return dqkv.view(qkv.shape), None, None, None


def flash_attention_qkv(qkv, seg, nh: int, hd: int) -> torch.Tensor:
    """Segment-masked attention over the [B, S, 3H] QKV projection ([q | k | v],
    heads contiguous), which the kernels read in place; seg: [B, S] 0/1 mask used
    as segment ids. Returns [B, S, nh, hd] in qkv's dtype. Differentiable in qkv,
    whose gradient the backward kernels write as one tensor."""
    return _FlashAttention.apply(qkv, seg.to(torch.int32), nh, hd)


def flash_attention(q, k, v, seg, hd: int) -> torch.Tensor:
    """Segment-masked attention in the reference's layout (``_flash_attention``,
    bert.py:159-189): q, k, v [B, S, nh, hd], seg [B, S]; returns [B, S, nh, hd].
    Differentiable in q, k and v. Joins them into one QKV tensor (a copy) for
    :func:`flash_attention_qkv`, which a caller holding the projection calls
    directly."""
    B, S, nh, _ = q.shape
    return flash_attention_qkv(torch.cat((q, k, v), dim=2).view(B, S, 3 * nh * hd), seg, nh, hd)

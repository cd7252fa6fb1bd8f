"""T5 encoder (Raffel et al., arXiv:1910.10683; HF ``T5EncoderModel``) in plain float32.

Pre-norm blocks with RMS norm (no mean, no bias): self-attention without the
1/sqrt(d_kv) scale plus a learned bias per head and relative-position bucket (shared by
every layer, bidirectional), residual; relu feed-forward, residual; a final RMS norm.
No dropout. The buckets follow T5's definition: offsets under half the buckets' half
exactly, the rest logarithmic up to ``relative_attention_max_distance``; the logarithm's
floor is taken in exact integer arithmetic, so no float rounding moves an offset that
lands on a bucket's edge. Weights: the benchmark's leaves, the layers stacked on axis 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from .precision import exact


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


def bucket(offset: int, num_buckets: int, max_distance: int) -> int:
    """The bidirectional bucket of ``offset`` = key position - query position."""
    half = num_buckets // 2
    base = half if offset > 0 else 0
    n = abs(offset)
    exact_max = half // 2
    if n < exact_max:
        return base + n
    # the largest b with exact_max * (max_distance / exact_max) ** (b / (half - exact_max))
    # <= n, i.e. n ** span >= exact_max ** span * (max_distance / exact_max) ** b
    span = half - exact_max
    b = 0
    while (b + 1 < span and n ** span * exact_max ** (b + 1)
           >= exact_max ** span * max_distance ** (b + 1)):
        b += 1
    return base + exact_max + b


def position_bias(table: torch.Tensor, S: int, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """[1, heads, S, S] float32 bias of the [buckets, heads] table."""
    ids = torch.tensor([[bucket(k - q, num_buckets, max_distance) for k in range(S)]
                        for q in range(S)], device=table.device)
    return table[ids].permute(2, 0, 1)[None]


def encode(w: Dict[str, torch.Tensor], cfg: Dict, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, cast=exact, max_distance: int = 128) -> torch.Tensor:
    """Last hidden states [B, S, d_model] float32."""
    nh, dk = cfg["num_heads"], cfg["d_kv"]
    eps = cfg["layer_norm_epsilon"]
    B, S = input_ids.shape
    x = w["shared"][input_ids.long()]
    bias = position_bias(w["enc_rel_bias"], S, cfg["relative_attention_num_buckets"],
                         max_distance)
    keep = attention_mask.bool()[:, None, None, :]

    def heads(t):
        return t.reshape(B, S, nh, dk).transpose(1, 2)

    for i in range(cfg["num_layers"]):
        h = _rms(x, w["encoder.attn_ln"][i], eps)
        q, k, v = (heads(torch.matmul(cast(h), cast(w[f"encoder.attn_{n}"][i]))) for n in "qkv")
        s = (torch.matmul(cast(q), cast(k.transpose(-1, -2))) + bias).masked_fill(
            ~keep, float("-inf"))
        ctx = torch.matmul(cast(torch.softmax(s, dim=-1)), cast(v))
        ctx = ctx.transpose(1, 2).reshape(B, S, nh * dk)
        x = x + torch.matmul(cast(ctx), cast(w["encoder.attn_o"][i]))
        h = _rms(x, w["encoder.ffn_ln"][i], eps)
        f = torch.relu(torch.matmul(cast(h), cast(w["encoder.wi"][i])))
        x = x + torch.matmul(cast(f), cast(w["encoder.wo"][i]))
    return _rms(x, w["enc_final_ln"], eps)

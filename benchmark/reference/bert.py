"""BERT encoder (Devlin et al., arXiv:1810.04805; HF ``BertModel``) in plain float32.

Post-LN blocks: self-attention over the real tokens (pad keys masked out), the output
projection, residual and LayerNorm, then the exact-GELU feed-forward, residual and
LayerNorm. Embeddings: word + position + token type, then LayerNorm. No dropout. The
weights are the benchmark's leaves (``benchmark/harness/weights.py``): ``[in, out]`` kernels,
q, k and v side by side in ``qkv_kernel`` with the heads contiguous in each. ``cast``
rounds the operands of every product (``precision.py``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .precision import exact


def _mm(a, b, cast):
    return torch.matmul(cast(a), cast(b))


def _ln(x, g, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def encode(w: Dict[str, torch.Tensor], cfg: Dict, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, cast=exact) -> torch.Tensor:
    """Last hidden states [B, S, H] float32 of int ``input_ids`` [B, S] and 0/1
    ``attention_mask`` [B, S] (token type 0 throughout)."""
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, eps = H // nh, cfg["layer_norm_eps"]
    B, S = input_ids.shape
    ids = input_ids.long()
    x = (w["embeddings.word"][ids] + w["embeddings.position"][:S][None]
         + w["embeddings.token_type"][0][None, None])
    x = _ln(x, w["embeddings.ln_scale"], w["embeddings.ln_bias"], eps)
    keep = attention_mask.bool()[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        qkv = _mm(x, w[p + "qkv_kernel"], cast) + w[p + "qkv_bias"]
        q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2) for t in qkv.split(H, dim=-1))
        s = _mm(q, k.transpose(-1, -2), cast) / math.sqrt(hd)
        s = s.masked_fill(~keep, float("-inf"))
        ctx = _mm(torch.softmax(s, dim=-1), v, cast).transpose(1, 2).reshape(B, S, H)
        x = _ln(x + _mm(ctx, w[p + "o_kernel"], cast) + w[p + "o_bias"],
                w[p + "attn_ln_scale"], w[p + "attn_ln_bias"], eps)
        h = torch.nn.functional.gelu(_mm(x, w[p + "wi_kernel"], cast) + w[p + "wi_bias"])
        x = _ln(x + _mm(h, w[p + "wo_kernel"], cast) + w[p + "wo_bias"],
                w[p + "mlp_ln_scale"], w[p + "mlp_ln_bias"], eps)
    return x

"""BERT encoder as a PyTorch module, on the reference's xla-path semantics.

Counterpart of ``denseretrievaltoolkits_tpu/models/bert.py``. The numerics
follow ``_encoder_block`` (bert.py:192-286): fused QKV ``[H,3H]`` projection,
fp32 LayerNorm, fp32 scores plus the additive -1e9 mask bias, fp32 softmax
with probs cast to the compute dtype, exact gelu, post-LN, and on the xla
path the residual added in the compute dtype. ``attention="fused"`` routes
each block through the K1 and K2 kernels (``ops/attn.py``), exactly where the
reference calls its Pallas kernels (bert.py:215-244). ``attention="flash"``
computes the context with the flash kernels (``ops/flash.py``, the stock
Pallas flash attention at bert.py:258-259) over segment ids, then follows the
xla path; unlike the reference, it runs them off the TPU too (the reference
runs 'flash' as 'xla' there, bert.py:331-332), and its pad rows attend only the
pad keys before S, where the reference's also average its 128-row padding:
real rows agree, pad rows differ but stay finite.

``remat`` recomputes activations in the backward instead of keeping them
(``bert_encode(remat=...)``, bert.py:296-345 there): ``'full'`` checkpoints each
block (``torch.utils.checkpoint``); ``'attn'`` checkpoints only the xla path's
attention, whose [B, nh, S, S] scores and probabilities are the tensors the
reference tags (bert.py:269-275). On ``'fused'`` and ``'flash'`` ``'attn'`` adds
nothing: K1 keeps only its inputs and recomputes in its backward, and the
reference tags no flash tensor.

Weights keep the reference's ``[in, out]`` kernel layout, so the JAX pytree
maps onto the module with no transpose (``models/convert.py``). Matrices and
biases are stored in ``param_dtype`` and cast to the compute dtype at every
use, as the reference does (bert.py:200-244): training keeps fp32 master
parameters, so gradients and optimizer state are fp32; serving stores them
in the compute dtype, where the cast is a no-op. Embeddings and LayerNorm
parameters stay fp32. Every parameter takes gradients, unless LoRA freezes the
base (``models/lora.py``: adapters on q and v, stored like the matrices).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import attn as attn_ops
from ..ops import flash as flash_ops
from ..parallel import mesh as tp

ATTENTIONS = ("xla", "flash", "fused")
REMATS = ("", "full", "attn")


@dataclass(frozen=True)
class BertConfig:
    """Same fields and ``bert_config.json`` as the reference ``BertConfig``."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, blob: str) -> "BertConfig":
        data = json.loads(blob)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


def save_config(config: BertConfig, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "bert_config.json"), "w") as fh:
        fh.write(config.to_json())


def load_config(path: str) -> BertConfig:
    with open(os.path.join(path, "bert_config.json")) as fh:
        return BertConfig.from_json(fh.read())


def layer_norm(x, scale, bias, eps):
    """LayerNorm in fp32 regardless of compute dtype (``_layer_norm``)."""
    return attn_ops.layer_norm_f32(x.float(), scale, bias, eps).to(x.dtype)


def _param(*shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c, f32 = config, torch.float32
        self.word = _param(c.vocab_size, c.hidden_size, dtype=f32, device=device)
        self.position = _param(c.max_position_embeddings, c.hidden_size, dtype=f32, device=device)
        self.token_type = _param(c.type_vocab_size, c.hidden_size, dtype=f32, device=device)
        self.ln_scale = _param(c.hidden_size, dtype=f32, device=device)
        self.ln_bias = _param(c.hidden_size, dtype=f32, device=device)


class BertLayer(nn.Module):
    """One post-LN block; parameter names follow the reference pytree."""

    def __init__(self, config: BertConfig, dtype: torch.dtype, device=None):
        super().__init__()
        H, F, f32 = config.hidden_size, config.intermediate_size, torch.float32
        self.qkv_kernel = _param(H, 3 * H, dtype=dtype, device=device)
        self.qkv_bias = _param(3 * H, dtype=dtype, device=device)
        self.o_kernel = _param(H, H, dtype=dtype, device=device)
        self.o_bias = _param(H, dtype=dtype, device=device)
        self.attn_ln_scale = _param(H, dtype=f32, device=device)
        self.attn_ln_bias = _param(H, dtype=f32, device=device)
        self.wi_kernel = _param(H, F, dtype=dtype, device=device)
        self.wi_bias = _param(F, dtype=dtype, device=device)
        self.wo_kernel = _param(F, H, dtype=dtype, device=device)
        self.wo_bias = _param(H, dtype=dtype, device=device)
        self.mlp_ln_scale = _param(H, dtype=f32, device=device)
        self.mlp_ln_bias = _param(H, dtype=f32, device=device)


def _dense(h, kernel, bias):
    """``jnp.dot(h, kernel.astype(cd), preferred_element_type=cd) + bias.astype(cd)``
    with cd = h's dtype."""
    return torch.matmul(h, kernel.to(h.dtype)) + bias.to(h.dtype)


def encoder_block(x, layer: BertLayer, mask, config: BertConfig, attention: str,
                  remat_attn: bool = False):
    """One post-LN BERT block. x [B,S,H] compute dtype; mask [B,S] 0/1.
    ``remat_attn``: on the xla path, recompute the attention in the backward.
    A layer with LoRA adapters (``models/lora.py``) adds them to q and v and runs
    the xla block on 'fused', never K1 / K2, as the reference (bert.py:215).

    A layer cut over a mesh's model axis (``parallel/mesh.py:shard_module``) runs
    Megatron's scheme on 'xla' and 'flash': this rank's heads and MLP columns,
    the row-parallel products summed over the model group before their bias,
    the residual and the LN (so the bias is added once), and the column-parallel
    products' input gradient summed in the backward. On 'fused' K1 / K2 fuse the
    out-projection and the LN, so no partial sum may enter them: the layer's
    leaves are all-gathered and the kernels run on the full weights, as GSPMD
    does around a ``pallas_call`` it cannot partition; each rank keeps its part
    of the weight gradient. LoRA adapters stay replicated: each rank adds its
    heads' columns of ``(x A) B``."""
    c = config
    nh, hd = c.num_attention_heads, c.head_dim
    mesh = getattr(layer, "tp", None)
    lora = getattr(layer, "lora_q_A", None) is not None
    w = {name: getattr(layer, name) for name in (
        "qkv_kernel", "qkv_bias", "o_kernel", "o_bias", "wi_kernel", "wi_bias", "wo_kernel",
        "wo_bias")}
    local = mesh is not None and not (attention == "fused" and not lora)
    if mesh is not None and not local:
        for name in ("qkv_kernel", "qkv_bias", "o_kernel", "wi_kernel", "wi_bias", "wo_kernel"):
            w[name] = tp.gather_leaf(w[name], mesh)
    x_in = tp.copy_to_model(x, mesh) if local else x
    qkv = _dense(x_in, w["qkv_kernel"], w["qkv_bias"])
    if local:
        nh = nh // mesh.tp
    if lora:
        # the reference adds (x A) B to q and v after its fused QKV product, each
        # product and the sum in the compute dtype (bert.py:248-254)
        H = qkv.shape[-1] // 3
        a_q, b_q, a_v, b_v = (getattr(layer, n).to(x.dtype) for n in (
            "lora_q_A", "lora_q_B", "lora_v_A", "lora_v_B"))
        if local:  # replicated adapters: their gradients summed over the model group
            a_q, b_q, a_v, b_v = (tp.copy_to_model(t, mesh) for t in (a_q, b_q, a_v, b_v))
            cols = slice(mesh.tp_rank * H, (mesh.tp_rank + 1) * H)
            b_q, b_v = b_q[:, cols], b_v[:, cols]
        delta_q = torch.matmul(torch.matmul(x_in, a_q), b_q)
        delta_v = torch.matmul(torch.matmul(x_in, a_v), b_v)
        qkv = torch.cat([qkv[..., :H] + delta_q, qkv[..., H:2 * H], qkv[..., 2 * H:] + delta_v],
                        dim=-1)
    if attention == "fused" and not lora:
        cd = x.dtype
        x = attn_ops.fused_attention_ln(
            qkv, x, mask, w["o_kernel"].to(cd), w["o_bias"].to(cd), layer.attn_ln_scale,
            layer.attn_ln_bias, 1.0 / math.sqrt(hd), nh, hd, c.layer_norm_eps)
        return attn_ops.fused_mlp_ln(
            x, w["wi_kernel"].to(cd), w["wi_bias"].to(cd), w["wo_kernel"].to(cd),
            w["wo_bias"].to(cd), layer.mlp_ln_scale, layer.mlp_ln_bias, c.layer_norm_eps)
    if attention == "flash":
        ctx = flash_ops.flash_attention_qkv(qkv, mask, nh, hd).reshape(
            qkv.shape[:-1] + (nh * hd,))
    elif remat_attn:
        ctx = checkpoint(attn_ops._reference_attention, qkv, mask, 1.0 / math.sqrt(hd), nh, hd,
                         use_reentrant=False)
    else:
        ctx = attn_ops._reference_attention(qkv, mask, 1.0 / math.sqrt(hd), nh, hd)
    # as the xla path: projection and residual in the compute dtype, fp32 LayerNorm
    if local:
        attn_out = _dense_sum(ctx, w["o_kernel"], w["o_bias"], mesh)
    else:
        attn_out = _dense(ctx, w["o_kernel"], w["o_bias"])
    x = layer_norm(x + attn_out, layer.attn_ln_scale, layer.attn_ln_bias, c.layer_norm_eps)
    h = _dense(tp.copy_to_model(x, mesh) if local else x, w["wi_kernel"], w["wi_bias"])
    h = torch.nn.functional.gelu(h)
    h = _dense_sum(h, w["wo_kernel"], w["wo_bias"], mesh) if local else \
        _dense(h, w["wo_kernel"], w["wo_bias"])
    return layer_norm(x + h, layer.mlp_ln_scale, layer.mlp_ln_bias, c.layer_norm_eps)


def _dense_sum(h, kernel, bias, mesh):
    """A row-parallel product: this rank's partial ``h . kernel`` in the compute dtype
    (as GSPMD's partitioned dot), summed over the model group in fp32, then the
    (replicated) bias once."""
    return tp.sum_over_model(torch.matmul(h, kernel.to(h.dtype)), mesh) + bias.to(h.dtype)


class BertEncoder(nn.Module):
    """BERT encoder + HF-style pooler. ``forward`` returns last_hidden_state
    [B,S,H] in ``dtype`` (the reference ``bert_encode``). ``param_dtype``
    (default: ``dtype``) is the storage dtype of matrices and biases;
    ``remat`` one of :data:`REMATS`, applied where autograd records."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 attention: str = "xla", device=None, param_dtype=None, remat: str = ""):
        super().__init__()
        if attention not in ATTENTIONS:
            raise ValueError(f"Unknown attention impl: {attention}")
        if remat not in REMATS:
            raise ValueError(f"Unknown remat: {remat!r} (one of {REMATS})")
        self.config = config
        self.dtype = dtype
        self.attention = attention
        self.remat = remat
        param_dtype = param_dtype or dtype
        self.embeddings = BertEmbeddings(config, device=device)
        self.layers = nn.ModuleList(
            BertLayer(config, param_dtype, device=device)
            for _ in range(config.num_hidden_layers))
        H = config.hidden_size
        self.pooler_kernel = _param(H, H, dtype=param_dtype, device=device)
        self.pooler_bias = _param(H, dtype=param_dtype, device=device)

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        c = self.config
        emb = self.embeddings
        S = input_ids.shape[1]
        x = emb.word[input_ids]
        x = x + emb.position[torch.arange(S, device=input_ids.device)][None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + emb.token_type[token_type_ids]
        x = layer_norm(x, emb.ln_scale, emb.ln_bias, c.layer_norm_eps).to(self.dtype)
        remat = self.remat if torch.is_grad_enabled() else ""
        for layer in self.layers:
            if remat == "full":
                x = checkpoint(encoder_block, x, layer, attention_mask, c, self.attention,
                               use_reentrant=False)
            else:
                x = encoder_block(x, layer, attention_mask, c, self.attention,
                                  remat_attn=remat == "attn")
        return x

    def pooler(self, hidden):
        """HF-style pooler: tanh(dense(CLS)) (``bert_pooler``)."""
        return torch.tanh(_dense(hidden[:, 0, :], self.pooler_kernel, self.pooler_bias))

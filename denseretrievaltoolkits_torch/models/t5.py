"""T5 encoder tower and single-step decoder, as PyTorch modules.

Counterpart of ``denseretrievaltoolkits_tpu/models/t5.py`` (:1-416): the
``T5EncoderModel`` tower of the dual encoder (backbone ``t5``) and the step-0
decoder of the token-scoring reranker and the full-T5 dual encoder (backbone
``t5_full``). The numerics are the reference's:

- RMS norm in fp32, cast back to the compute dtype (``_rms_norm``, :95-99);
- each projection rounded to the compute dtype (``preferred_element_type``), the
  self-attention's q, k and v from one fused product; no 1/sqrt(d_kv) scaling;
  scores in fp32 plus the -1e9 mask bias and the position bias, probabilities
  cast to the compute dtype (:137-179); the residual stream in the compute dtype;
- the FFN relu, or gated with tanh-GELU (``is_gated_act``, :182-190);
- the decoder's one input is ``shared[pad_token_id]`` (:253-255); tied logits
  scale its fp32 state by d_model^-0.5 (:278-283).

The relative-position buckets truncate an fp32 ``log`` to an integer
(:114-118), and some offsets land exactly on an integer there (at 32 buckets
over 128 positions, +-16, 32 and 64 give 2.0, 4.0 and 6.0): a ``log`` one ulp
low puts them in the bucket below. CUDA's ``logf`` is not correctly rounded, so
the bucket table is built on the host, in fp32 on the CPU as the reference
computes it, once per (q_len, k_len), and copied to the table's device; every
layer shares it, as the reference shares its bias.

Weights keep the reference's layout: the layers stacked on axis 0 (``encoder``
and ``decoder``), kernels ``[in, out]``; a state dict key is the reference's
pytree path with ``.`` for ``/`` (``models/convert.py``). Matrices are stored
in ``param_dtype`` and cast to the compute dtype at use; ``shared``, the
relative-bias tables, the RMS-norm scales and ``lm_head`` stay fp32, as the
reference reads them (``astype(float32)``). Encoder LoRA adapters
(``models/lora.py:add_lora_t5``) are four more stacked leaves of ``encoder``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .bert import REMATS

_NEG = -1e9


@dataclass(frozen=True)
class T5Config:
    """Same fields and ``t5_config.json`` as the reference ``T5Config``."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    pad_token_id: int = 0
    tie_word_embeddings: bool = True
    is_gated_act: bool = False  # True for t5 v1.1 (gelu gated)

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, blob: str) -> "T5Config":
        data = json.loads(blob)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})

    @classmethod
    def from_hf_config(cls, hf: Dict) -> "T5Config":
        """A parsed HF ``config.json`` (a dict) -> ``T5Config``, as the reference's
        ``from_hf_config`` maps an HF ``T5Config`` (:60-74): ``is_gated_act`` from
        ``feed_forward_proj``, ``relative_attention_max_distance`` 128 where absent;
        other absent keys take HF ``T5Config``'s defaults."""
        get = lambda k: hf.get(k, HF_T5_DEFAULTS[k])  # noqa: E731
        return cls(
            vocab_size=get("vocab_size"), d_model=get("d_model"), d_kv=get("d_kv"),
            d_ff=get("d_ff"), num_layers=get("num_layers"), num_heads=get("num_heads"),
            relative_attention_num_buckets=get("relative_attention_num_buckets"),
            relative_attention_max_distance=get("relative_attention_max_distance"),
            layer_norm_epsilon=get("layer_norm_epsilon"), pad_token_id=get("pad_token_id"),
            tie_word_embeddings=get("tie_word_embeddings"),
            is_gated_act="gated" in get("feed_forward_proj"))


# HF T5Config's defaults, for keys a config.json leaves out
HF_T5_DEFAULTS = dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6,
                      num_heads=8, relative_attention_num_buckets=32,
                      relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
                      pad_token_id=0, tie_word_embeddings=True, feed_forward_proj="relu")


def save_config(config: T5Config, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "t5_config.json"), "w") as fh:
        fh.write(config.to_json())


def load_config(path: str) -> T5Config:
    with open(os.path.join(path, "t5_config.json")) as fh:
        return T5Config.from_json(fh.read())


# -- core math ------------------------------------------------------------------------------------

def _rms_norm(x, scale, eps):
    """RMS norm in fp32, cast back to ``x``'s dtype (``_rms_norm``)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bucketed relative positions (``_relative_position_bucket``, :102-121), on the
    CPU in fp32: int64 buckets of an int64 tensor of offsets (key - query)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    f32 = torch.float32
    # divide by tensors: a Python scalar divisor becomes a multiply by its reciprocal
    ratio = n.to(f32) / torch.tensor(max_exact, dtype=f32) + torch.tensor(1e-9, dtype=f32)
    scaled = (torch.log(ratio) / torch.tensor(math.log(max_distance / max_exact), dtype=f32)
              * torch.tensor(num_buckets - max_exact, dtype=f32))
    val_if_large = (max_exact + scaled.to(torch.int32).long()).clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


@functools.lru_cache(maxsize=64)
def _host_buckets(q_len, k_len, bidirectional, num_buckets, max_distance) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode: autograd saves it
    with torch.inference_mode(False):
        ctx = torch.arange(q_len)[:, None]
        mem = torch.arange(k_len)[None, :]
        return relative_position_bucket(mem - ctx, bidirectional, num_buckets, max_distance)


_DEVICE_BUCKETS: Dict = {}


def bucket_table(q_len: int, k_len: int, config: T5Config, bidirectional: bool = True,
                 device=None) -> torch.Tensor:
    """[q_len, k_len] int64 bucket ids, built on the host and copied once to ``device``."""
    host = _host_buckets(q_len, k_len, bidirectional, config.relative_attention_num_buckets,
                         config.relative_attention_max_distance)
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        return host
    key = (q_len, k_len, bidirectional, config.relative_attention_num_buckets,
           config.relative_attention_max_distance, str(device))
    table = _DEVICE_BUCKETS.get(key)
    if table is None:
        if len(_DEVICE_BUCKETS) >= 64:
            _DEVICE_BUCKETS.clear()
        with torch.inference_mode(False):
            table = _DEVICE_BUCKETS[key] = host.to(device)
    return table


def position_bias(rel_bias_table: torch.Tensor, q_len: int, k_len: int, config: T5Config,
                  bidirectional: bool = True) -> torch.Tensor:
    """[1, heads, q_len, k_len] fp32 additive bias from the bucket embedding table."""
    buckets = bucket_table(q_len, k_len, config, bidirectional, rel_bias_table.device)
    return rel_bias_table.float()[buckets].permute(2, 0, 1)[None]


def _dot(h, kernel):
    """``jnp.dot(h, kernel.astype(cd), preferred_element_type=cd)``, cd = h's dtype."""
    return torch.matmul(h, kernel.to(h.dtype))


def _attention(x_q, x_kv, layer, prefix, config: T5Config, mask_bias, pos_bias):
    """The reference ``_attention`` (:137-179); ``x_kv`` None for self-attention."""
    B, Sq, _ = x_q.shape
    nh, dk, inner = config.num_heads, config.d_kv, config.inner_dim
    if x_kv is None:  # self-attention: one fused QKV projection
        x_kv = x_q
        kern = torch.cat([layer[f"{prefix}_{n}"] for n in "qkv"], dim=-1)
        q, k, v = _dot(x_q, kern).split(inner, dim=-1)
    else:  # cross-attention: q from the decoder stream, fused KV from memory
        q = _dot(x_q, layer[f"{prefix}_q"])
        k, v = _dot(x_kv, torch.cat([layer[f"{prefix}_k"], layer[f"{prefix}_v"]], dim=-1)
                    ).split(inner, dim=-1)
    Sk = x_kv.shape[1]
    if prefix == "attn" and "lora_q_A" in layer:  # encoder LoRA (models/lora.py)
        q = q + _dot(_dot(x_q, layer["lora_q_A"]), layer["lora_q_B"])
        v = v + _dot(_dot(x_kv, layer["lora_v_A"]), layer["lora_v_B"])
    q = q.reshape(B, Sq, nh, dk)
    k = k.reshape(B, Sk, nh, dk)
    v = v.reshape(B, Sk, nh, dk)
    # NB: T5 does NOT scale q by 1/sqrt(d_kv); products of compute-dtype values, fp32 sums
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores + mask_bias + pos_bias
    probs = torch.softmax(scores, dim=-1).to(x_q.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return _dot(ctx.reshape(B, Sq, inner), layer[f"{prefix}_o"])


def _ffn(x, layer, config: T5Config):
    if config.is_gated_act:
        h = (torch.nn.functional.gelu(_dot(x, layer["wi_0"]), approximate="tanh")
             * _dot(x, layer["wi_1"]))
    else:
        h = torch.relu(_dot(x, layer["wi"]))
    return _dot(h, layer["wo"])


def _encoder_block(h, layer, config: T5Config, mask_bias, pos_bias):
    eps = config.layer_norm_epsilon
    a_in = _rms_norm(h, layer["attn_ln"], eps)
    h = h + _attention(a_in, None, layer, "attn", config, mask_bias, pos_bias)
    f_in = _rms_norm(h, layer["ffn_ln"], eps)
    return h + _ffn(f_in, layer, config)


def _decoder_block(h, layer, config: T5Config, enc_h, enc_bias, self_bias, zero):
    eps = config.layer_norm_epsilon
    a_in = _rms_norm(h, layer["self_ln"], eps)
    h = h + _attention(a_in, None, layer, "self", config, zero, self_bias)
    x_in = _rms_norm(h, layer["cross_ln"], eps)
    h = h + _attention(x_in, enc_h, layer, "cross", config, enc_bias, zero)
    f_in = _rms_norm(h, layer["ffn_ln"], eps)
    return h + _ffn(f_in, layer, config)


# -- modules --------------------------------------------------------------------------------------

_NORMS = ("attn_ln", "ffn_ln", "self_ln", "cross_ln")


def layer_shapes(config: T5Config, decoder: bool = False) -> Dict[str, tuple]:
    """Each stacked leaf's shape, in the reference's init order (:304-339)."""
    c = config
    L, D, F, I = c.num_layers, c.d_model, c.d_ff, c.inner_dim
    out: Dict[str, tuple] = {}
    for prefix in (("self", "cross") if decoder else ("attn",)):
        out.update({f"{prefix}_q": (L, D, I), f"{prefix}_k": (L, D, I), f"{prefix}_v": (L, D, I),
                    f"{prefix}_o": (L, I, D)})
    for name in (("self_ln", "cross_ln", "ffn_ln") if decoder else ("attn_ln", "ffn_ln")):
        out[name] = (L, D)
    out["wo"] = (L, F, D)
    if c.is_gated_act:
        out.update(wi_0=(L, D, F), wi_1=(L, D, F))
    else:
        out["wi"] = (L, D, F)
    return out


class StackedLayers(nn.Module):
    """The layers' weights stacked on axis 0, one parameter a leaf (the reference's
    ``params["encoder"]`` / ``params["decoder"]``)."""

    def __init__(self, shapes: Dict[str, tuple], dtype, device=None):
        super().__init__()
        for name, shape in shapes.items():
            dt = torch.float32 if name in _NORMS else dtype
            self.register_parameter(name, nn.Parameter(torch.zeros(shape, dtype=dt,
                                                                   device=device)))

    def layers(self):
        """One dict of name -> [layer i] view a layer (``unbind``: one gradient stack)."""
        names = [n for n, _ in self.named_parameters(recurse=False)]
        per = zip(*(p.unbind(0) for _, p in self.named_parameters(recurse=False)))
        return [dict(zip(names, vals)) for vals in per]


def _fp32_param(*shape, device):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


class T5Model(nn.Module):
    """T5 encoder (and with ``with_decoder`` the step-0 decoder). ``forward`` is
    ``t5_encode``: last_hidden_state [B, S, d_model] in ``dtype``. ``remat``
    'full' or 'attn' checkpoints each encoder block where autograd records (the
    reference checkpoints the block for any truthy ``remat``, :220-221)."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32, device=None,
                 param_dtype=None, remat: str = "", with_decoder: bool = False):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"Unknown remat: {remat!r} (one of {REMATS})")
        c = config
        self.config = config
        self.dtype = dtype
        self.remat = remat
        param_dtype = param_dtype or dtype
        self.shared = _fp32_param(c.vocab_size, c.d_model, device=device)
        self.enc_rel_bias = _fp32_param(c.relative_attention_num_buckets, c.num_heads,
                                        device=device)
        self.encoder = StackedLayers(layer_shapes(c), param_dtype, device=device)
        self.enc_final_ln = _fp32_param(c.d_model, device=device)
        self.decoder = None
        self.lm_head = None
        if with_decoder:
            self.decoder = StackedLayers(layer_shapes(c, decoder=True), param_dtype,
                                         device=device)
            self.dec_rel_bias = _fp32_param(c.relative_attention_num_buckets, c.num_heads,
                                            device=device)
            self.dec_final_ln = _fp32_param(c.d_model, device=device)
            if not c.tie_word_embeddings:
                self.lm_head = _fp32_param(c.d_model, c.vocab_size, device=device)

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        """``t5_encode``; ``token_type_ids`` is accepted for batch-shape parity, unused."""
        c = self.config
        S = input_ids.shape[1]
        x = self.shared[input_ids].to(self.dtype)
        mask_bias = (1.0 - attention_mask.float())[:, None, None, :] * _NEG
        pos_bias = position_bias(self.enc_rel_bias, S, S, c, bidirectional=True)
        remat = bool(self.remat) and torch.is_grad_enabled()
        for layer in self.encoder.layers():
            if remat:
                x = checkpoint(_encoder_block, x, layer, c, mask_bias, pos_bias,
                               use_reentrant=False)
            else:
                x = _encoder_block(x, layer, c, mask_bias, pos_bias)
        return _rms_norm(x, self.enc_final_ln, c.layer_norm_epsilon)

    def decode_step0(self, encoder_hidden, encoder_mask, return_logits: bool = True):
        """``t5_decode_step0`` (:237-283): one decoder step from ``shared[pad_token_id]``
        -> fp32 lm logits [B, vocab], or the fp32 step-0 state [B, d_model] with
        ``return_logits=False`` (the full-T5 dual encoder's rep)."""
        if self.decoder is None:
            raise ValueError("this T5 tower has no decoder (built with with_decoder=False)")
        c = self.config
        B = encoder_hidden.shape[0]
        x = self.shared[c.pad_token_id][None, None, :].expand(B, 1, c.d_model).to(self.dtype)
        enc_bias = (1.0 - encoder_mask.float())[:, None, None, :] * _NEG
        self_bias = position_bias(self.dec_rel_bias, 1, 1, c, bidirectional=False)
        zero = torch.zeros((1, 1, 1, 1), dtype=torch.float32, device=x.device)
        enc_h = encoder_hidden.to(self.dtype)
        for layer in self.decoder.layers():
            x = _decoder_block(x, layer, c, enc_h, enc_bias, self_bias, zero)
        x = _rms_norm(x, self.dec_final_ln, c.layer_norm_epsilon)
        x32 = x[:, 0, :].float()
        if not return_logits:
            return x32
        if c.tie_word_embeddings:
            return torch.matmul(x32 * (c.d_model ** -0.5), self.shared.float().T)
        return torch.matmul(x32, self.lm_head.float())


# -- init, HF import --------------------------------------------------------------------------------

def init_params_numpy(config: T5Config, seed=0, with_decoder: bool = False) -> Dict:
    """Seeded random pytree in the reference layout: the shapes and scales of
    ``init_params`` (:291-344), N(0, 1) x std drawn with ``np.random.default_rng(seed)``
    in its order (numpy draws, not JAX's), unit RMS-norm scales."""
    c = config
    L, D, F, I = c.num_layers, c.d_model, c.d_ff, c.inner_dim
    rng = np.random.default_rng(seed)

    def dense(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def layers(decoder):
        out = {}
        for prefix in (("self", "cross") if decoder else ("attn",)):
            out[f"{prefix}_q"] = dense((L, D, I), (D * c.d_kv) ** -0.5)
            out[f"{prefix}_k"] = dense((L, D, I), D ** -0.5)
            out[f"{prefix}_v"] = dense((L, D, I), D ** -0.5)
            out[f"{prefix}_o"] = dense((L, I, D), I ** -0.5)
        for name in (("self_ln", "cross_ln", "ffn_ln") if decoder else ("attn_ln", "ffn_ln")):
            out[name] = np.ones((L, D), np.float32)
        out["wo"] = dense((L, F, D), F ** -0.5)
        if c.is_gated_act:
            out["wi_0"] = dense((L, D, F), D ** -0.5)
            out["wi_1"] = dense((L, D, F), D ** -0.5)
        else:
            out["wi"] = dense((L, D, F), D ** -0.5)
        return out

    params = {"shared": dense((c.vocab_size, D), 1.0),
              "enc_rel_bias": dense((c.relative_attention_num_buckets, c.num_heads), 1.0),
              "encoder": layers(False), "enc_final_ln": np.ones((D,), np.float32)}
    if with_decoder:
        params["decoder"] = layers(True)
        params["dec_rel_bias"] = dense((c.relative_attention_num_buckets, c.num_heads), 1.0)
        params["dec_final_ln"] = np.ones((D,), np.float32)
        if not c.tie_word_embeddings:
            params["lm_head"] = dense((D, c.vocab_size), D ** -0.5)
    return params


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


_ENC_MAP = (("attn_q", "0.SelfAttention.q", True), ("attn_k", "0.SelfAttention.k", True),
            ("attn_v", "0.SelfAttention.v", True), ("attn_o", "0.SelfAttention.o", True),
            ("attn_ln", "0.layer_norm", False), ("ffn_ln", "1.layer_norm", False))
_DEC_MAP = (("self_q", "0.SelfAttention.q", True), ("self_k", "0.SelfAttention.k", True),
            ("self_v", "0.SelfAttention.v", True), ("self_o", "0.SelfAttention.o", True),
            ("self_ln", "0.layer_norm", False), ("cross_q", "1.EncDecAttention.q", True),
            ("cross_k", "1.EncDecAttention.k", True), ("cross_v", "1.EncDecAttention.v", True),
            ("cross_o", "1.EncDecAttention.o", True), ("cross_ln", "1.layer_norm", False),
            ("ffn_ln", "2.layer_norm", False))


def params_from_torch_state_dict(state_dict, config: T5Config,
                                 with_decoder: bool = False) -> Dict:
    """An HF torch ``T5EncoderModel`` / ``T5ForConditionalGeneration`` state dict
    (tensors or numpy arrays) -> the reference-layout numpy tree, fp32 (:347-416).
    The embedding is ``shared.weight``, or ``encoder.embed_tokens.weight`` where a
    saved file kept only that name of the tied pair. As the reference, ``num_layers``
    decoder blocks are stacked (``num_decoder_layers`` is not read) and ``lm_head``
    is read for an untied config only."""

    def a(name):
        return _np(state_dict[name])

    def t(name):  # torch Linear stores [out, in]; the tree [in, out]
        return np.ascontiguousarray(a(name).T)

    L = config.num_layers

    def stack(side, fmt, transpose):
        get = t if transpose else a
        return np.stack([get(f"{side}.block.{i}.layer.{fmt}.weight") for i in range(L)])

    def ffn(side, sub):
        names = ("wi_0", "wi_1") if config.is_gated_act else ("wi",)
        out = {n: stack(side, f"{sub}.DenseReluDense.{n}", True) for n in names}
        out["wo"] = stack(side, f"{sub}.DenseReluDense.wo", True)
        return out

    enc = {ours: stack("encoder", theirs, tr) for ours, theirs, tr in _ENC_MAP}
    enc.update(ffn("encoder", 1))
    shared = "shared.weight" if "shared.weight" in state_dict else "encoder.embed_tokens.weight"
    params = {"shared": a(shared),
              "enc_rel_bias": a("encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
                                ".weight"),
              "encoder": enc, "enc_final_ln": a("encoder.final_layer_norm.weight")}
    if with_decoder:
        dec = {ours: stack("decoder", theirs, tr) for ours, theirs, tr in _DEC_MAP}
        dec.update(ffn("decoder", 2))
        params["decoder"] = dec
        params["dec_rel_bias"] = a("decoder.block.0.layer.0.SelfAttention.relative_attention_bias"
                                   ".weight")
        params["dec_final_ln"] = a("decoder.final_layer_norm.weight")
        if not config.tie_word_embeddings and "lm_head.weight" in state_dict:
            params["lm_head"] = t("lm_head.weight")
    return params

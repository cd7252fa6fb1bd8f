"""Random weights of a configuration, made on the device from the seed.

Every leaf is named and laid out as the port's tower holds it (``[in, out]`` kernels, the
BERT q, k, v kernels side by side in ``qkv_kernel``, the T5 layers stacked on axis 0), so
the same tensors load into the port by ``load_state_dict`` and are read by the plain
reference in ``benchmark/reference/``. All normal leaves come from one ``torch.randn``
call on the device, then are scaled by their own standard deviation.

BERT: every matrix, bias and embedding N(0, initializer_range), the LayerNorm scales 1
and their biases 0 (BERT's initializer, with the biases drawn too so that none is
trivially 0). T5: the port's and HF's ``T5PreTrainedModel._init_weights`` scales
(q (d_model d_kv)^-1/2, k, v and wi d_model^-1/2, o inner^-1/2, wo d_ff^-1/2, the
embedding and the relative-bias table 1), RMS-norm scales 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .traffic import torch_gen

Leaf = Tuple[str, Tuple[int, ...], float]  # name, shape, std (0: ones; -1: zeros)
ONES, ZEROS = 0.0, -1.0


def bert_leaves(cfg: Dict) -> List[Leaf]:
    H, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    std = cfg["initializer_range"]
    out: List[Leaf] = [
        ("embeddings.word", (V, H), std),
        ("embeddings.position", (cfg["max_position_embeddings"], H), std),
        ("embeddings.token_type", (cfg["type_vocab_size"], H), std),
        ("embeddings.ln_scale", (H,), ONES), ("embeddings.ln_bias", (H,), ZEROS)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "qkv_kernel", (H, 3 * H), std), (p + "qkv_bias", (3 * H,), std),
                (p + "o_kernel", (H, H), std), (p + "o_bias", (H,), std),
                (p + "attn_ln_scale", (H,), ONES), (p + "attn_ln_bias", (H,), ZEROS),
                (p + "wi_kernel", (H, F), std), (p + "wi_bias", (F,), std),
                (p + "wo_kernel", (F, H), std), (p + "wo_bias", (H,), std),
                (p + "mlp_ln_scale", (H,), ONES), (p + "mlp_ln_bias", (H,), ZEROS)]
    out += [("pooler_kernel", (H, H), std), ("pooler_bias", (H,), std)]
    return out


def t5_leaves(cfg: Dict) -> List[Leaf]:
    L, D, F = cfg["num_layers"], cfg["d_model"], cfg["d_ff"]
    I = cfg["num_heads"] * cfg["d_kv"]
    return [("shared", (cfg["vocab_size"], D), 1.0),
            ("enc_rel_bias", (cfg["relative_attention_num_buckets"], cfg["num_heads"]), 1.0),
            ("encoder.attn_q", (L, D, I), (D * cfg["d_kv"]) ** -0.5),
            ("encoder.attn_k", (L, D, I), D ** -0.5),
            ("encoder.attn_v", (L, D, I), D ** -0.5),
            ("encoder.attn_o", (L, I, D), I ** -0.5),
            ("encoder.attn_ln", (L, D), ONES), ("encoder.ffn_ln", (L, D), ONES),
            ("encoder.wo", (L, F, D), F ** -0.5), ("encoder.wi", (L, D, F), D ** -0.5),
            ("enc_final_ln", (D,), ONES)]


LEAVES = {"bert": bert_leaves, "t5": t5_leaves}


def leaves(config: Dict) -> List[Leaf]:
    """The leaves of a configuration file's model (its HF ``model_type``)."""
    return LEAVES[config["model_type"]](config)


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{leaf name: fp32 tensor on ``device``}: the same seed gives the same weights."""
    spec = leaves(config)
    numel = [int(torch.Size(shape).numel()) for _, shape, _ in spec]
    n_random = sum(n for n, (_, _, std) in zip(numel, spec) if std > 0)
    flat = torch.randn(n_random, generator=torch_gen(device, seed, "weights"), device=device)
    out, at = {}, 0
    for n, (name, shape, std) in zip(numel, spec):
        if std > 0:
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif std == ONES:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def pieces(config: Dict, name: str, t: torch.Tensor):
    """The published architecture's parameters inside one of the port's leaves, as
    [(name, view)]: BERT's fused ``qkv_*`` holds the query, key and value projections
    side by side (HF ``query`` / ``key`` / ``value``); T5's stacked leaves hold one
    parameter a layer. Norms per parameter are compared by these, so that a key bias,
    whose gradient is nought under softmax, is a parameter of its own."""
    if config["model_type"] == "bert" and ".qkv_" in name:
        H = t.shape[-1] // 3
        return [(name.replace("qkv_", f"{p}_"), t[..., i * H:(i + 1) * H])
                for i, p in enumerate("qkv")]
    if config["model_type"] == "t5" and ".encoder." in "." + name:
        head, leaf = name.rsplit(".", 1)
        return [(f"{head}.{i}.{leaf}", t[i]) for i in range(t.shape[0])]
    return [(name, t)]


def piece_norms(config: Dict, tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{parameter: norm} of {port leaf: tensor} by :func:`pieces`."""
    return {n: float(v.float().norm()) for name, t in tensors.items()
            for n, v in pieces(config, name, t)}

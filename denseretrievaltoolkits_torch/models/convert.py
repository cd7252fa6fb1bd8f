"""Weight bridge between the reference's JAX pytree and the port's modules.

The reference stores a BERT as a nested dict (``bert.init_params``,
bert.py:96-140): kernels ``[in, out]``, the transformer layers stacked on
axis 0, saved flat as ``weights.npz`` with ``"a/b"`` keys
(``bert.save_params``, bert.py:387-394). These helpers read that layout with
numpy only, so a retriever trained with the JAX package is served by the port
unchanged, and build a seeded random pytree of the same layout where no
checkpoint exists. The inverse bridge (:func:`params_to_jax`,
:func:`save_jax_params`) writes a port-trained encoder in that layout, so the
JAX package loads it with ``bert.load_params``. LoRA adapters travel as the
reference's four stacked leaves, ``lora_q_A`` / ``lora_v_A`` ``[L, H, r]`` and
``lora_q_B`` / ``lora_v_B`` ``[L, r, H]`` (``models/lora.py``), in both directions.

A T5 tree (``models/t5.py``: ``shared``, ``enc_rel_bias``, ``encoder``,
``enc_final_ln``, and with a decoder ``decoder``, ``dec_rel_bias``,
``dec_final_ln``, ``lm_head``; the encoder's LoRA leaves inside ``encoder``) maps
onto a ``T5Model`` key for key, its ``a/b`` paths as ``a.b``: both functions
take either kind of tree.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .bert import BertConfig
from .lora import LORA_KEYS

_LAYER_KEYS = ("o_kernel", "o_bias", "attn_ln_scale", "attn_ln_bias", "wi_kernel", "wi_bias",
               "wo_kernel", "wo_bias", "mlp_ln_scale", "mlp_ln_bias")
_QKV = ("q_kernel", "q_bias", "k_kernel", "k_bias", "v_kernel", "v_bias")


def is_t5_tree(tree: Dict) -> bool:
    return "encoder" in tree and "layers" not in tree


def _t5_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    lora = [k for k in LORA_KEYS if k in tree["encoder"]]
    if lora and len(lora) != len(LORA_KEYS):
        raise ValueError(f"incomplete LoRA adapters {lora}: a tower has all of {LORA_KEYS} "
                         f"or none")
    out = {}
    for k, v in tree.items():
        items = v.items() if isinstance(v, dict) else [(None, v)]
        for sub, leaf in items:
            out[k if sub is None else f"{k}.{sub}"] = torch.tensor(np.asarray(leaf, np.float32))
    return out


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX BERT pytree (numpy arrays) -> ``BertEncoder`` state_dict (fp32;
    ``load_state_dict`` casts to the module's storage dtypes). Q/K/V fuse
    into the ``[H,3H]`` kernel the encoder multiplies by. A T5 tree -> the
    ``T5Model`` state dict."""
    if is_t5_tree(tree):
        return _t5_from_jax(tree)
    layers = tree["layers"]
    unknown = set(layers) - set(_LAYER_KEYS) - set(_QKV) - set(LORA_KEYS)
    if unknown:
        raise NotImplementedError(f"layer params {sorted(unknown)} are not served by the port")
    lora = [k for k in LORA_KEYS if k in layers]
    if lora and len(lora) != len(LORA_KEYS):
        raise ValueError(f"incomplete LoRA adapters {lora}: a tower has all of {LORA_KEYS} "
                         f"or none")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))  # noqa: E731
    emb = tree["embeddings"]
    out = {f"embeddings.{k}": t(emb[k])
           for k in ("word", "position", "token_type", "ln_scale", "ln_bias")}
    L = np.asarray(layers["o_kernel"]).shape[0]
    for i in range(L):
        p = f"layers.{i}."
        out[p + "qkv_kernel"] = t(np.concatenate(
            [np.asarray(layers[n][i]) for n in ("q_kernel", "k_kernel", "v_kernel")], axis=-1))
        out[p + "qkv_bias"] = t(np.concatenate(
            [np.asarray(layers[n][i]) for n in ("q_bias", "k_bias", "v_bias")], axis=-1))
        for k in _LAYER_KEYS + tuple(lora):
            out[p + k] = t(np.asarray(layers[k][i]))
    out["pooler_kernel"] = t(tree["pooler"]["kernel"])
    out["pooler_bias"] = t(tree["pooler"]["bias"])
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """``BertEncoder`` state_dict (or any dict of the same keys, e.g. its
    gradients) -> the JAX BERT pytree of fp32 numpy arrays: ``qkv_*`` splits
    back into ``q/k/v`` and the layers stack on axis 0. Inverse of
    :func:`params_from_jax`. The arrays are copies: later in-place updates of
    the module do not reach them. A ``T5Model`` state dict -> the T5 tree."""
    n = lambda t: np.array(t.detach().float().cpu())  # noqa: E731
    if "shared" in state:
        tree: Dict = {}
        for k, v in state.items():
            head, _, leaf = k.partition(".")
            if leaf:
                tree.setdefault(head, {})[leaf] = n(v)
            else:
                tree[head] = n(v)
        return tree
    L = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("layers."))
    layer = [{k.split(".", 2)[2]: n(v) for k, v in state.items()
              if k.startswith(f"layers.{i}.")} for i in range(L)]
    layers = {k: np.stack([lay[k] for lay in layer]) for k in _LAYER_KEYS + LORA_KEYS
              if k in layer[0]}
    for fused, parts in (("qkv_kernel", _QKV[0::2]), ("qkv_bias", _QKV[1::2])):
        stacked = np.stack([lay[fused] for lay in layer])
        for name, part in zip(parts, np.split(stacked, 3, axis=-1)):
            layers[name] = np.ascontiguousarray(part)
    emb = {k: n(state[f"embeddings.{k}"])
           for k in ("word", "position", "token_type", "ln_scale", "ln_bias")}
    return {"embeddings": emb, "layers": layers,
            "pooler": {"kernel": n(state["pooler_kernel"]), "bias": n(state["pooler_bias"])}}


def save_jax_params(tree: Dict, path: str, name: str = "weights") -> None:
    """Write a nested numpy pytree as ``<path>/<name>.npz`` with ``"a/b"``
    keys, as ``bert.save_params`` does (bert.py:365-389)."""

    def flat(node, prefix=""):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                yield from flat(v, key)
            else:
                yield key, np.asarray(v)

    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"{name}.npz"), **dict(flat(tree)))


def load_jax_params(path: str, name: str = "weights") -> Dict:
    """Read ``<path>/<name>.npz`` as written by ``bert.save_params`` into the
    nested numpy pytree."""
    tree: Dict = {}
    with np.load(os.path.join(path, f"{name}.npz")) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    return tree


def init_params_numpy(config: BertConfig, seed: int = 0) -> Dict:
    """Seeded random pytree in the reference layout: N(0, initializer_range)
    matrices, zero biases, unit LayerNorm scales (the shapes of
    ``bert.init_params``; numpy draws, not JAX's)."""
    c = config
    L, H, F, V = c.num_hidden_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(c.initializer_range)

    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    ones = lambda *s: np.ones(s, np.float32)  # noqa: E731
    return {
        "embeddings": {
            "word": normal(V, H), "position": normal(c.max_position_embeddings, H),
            "token_type": normal(c.type_vocab_size, H), "ln_scale": ones(H), "ln_bias": zeros(H),
        },
        "layers": {
            "q_kernel": normal(L, H, H), "q_bias": zeros(L, H),
            "k_kernel": normal(L, H, H), "k_bias": zeros(L, H),
            "v_kernel": normal(L, H, H), "v_bias": zeros(L, H),
            "o_kernel": normal(L, H, H), "o_bias": zeros(L, H),
            "attn_ln_scale": ones(L, H), "attn_ln_bias": zeros(L, H),
            "wi_kernel": normal(L, H, F), "wi_bias": zeros(L, F),
            "wo_kernel": normal(L, F, H), "wo_bias": zeros(L, H),
            "mlp_ln_scale": ones(L, H), "mlp_ln_bias": zeros(L, H),
        },
        "pooler": {"kernel": normal(H, H), "bias": zeros(H)},
    }

"""LoRA adapters on the BERT and T5 towers.

Counterpart of ``denseretrievaltoolkits_tpu/models/lora.py`` (:26-99): rank-r
adapters on the attention's q and v projections. Each ``BertLayer`` gets
``lora_q_A`` / ``lora_v_A`` ``[H, r]``, drawn N(0, 1) x ``H ** -0.5``, and
``lora_q_B`` / ``lora_v_B`` ``[r, H]`` of zeros, so an adapted tower starts
exactly at its base. ``models/bert.py:encoder_block`` adds ``(x A) B`` to the
q and v column slices of the fused ``[H, 3H]`` projection, and runs a LoRA
layer on the xla block, never through K1 / K2, as the reference does
(bert.py:215).

Freezing the base is the optimizer's concern: :func:`lora_trainable` lists
what trains (the adapters and the projection heads) and takes the gradient off
everything else (``train/optimizers.py``), the counterpart of ``lora_mask``.
The draws are numpy's, not ``jax.random``'s: a tower built from the same seed
has the same adapters in either package only when they are carried across
(``models/convert.py`` maps the four stacked leaves both ways).

A T5 tower (``models/t5.py``) takes them on its encoder's q and v
(:func:`add_lora_t5`, lora.py:44-57 there): stacked leaves of ``encoder``,
``lora_q_A`` / ``lora_v_A`` ``[L, d_model, r]`` and ``lora_q_B`` / ``lora_v_B``
``[L, r, inner]``, applied only in the encoder's self-attention. The reference
has no T5 merge and no T5 export (its ``merge_lora`` reads ``layers``, its HF
export writes BERT keys), so :func:`merge_lora` and :func:`merge_lora_tree` raise
on a T5 tower.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from .t5 import T5Model

LORA_KEYS = ("lora_q_A", "lora_q_B", "lora_v_A", "lora_v_B")
HEADS = ("head_q", "head_p", "head")


def _add_layer_adapters(layer, a_q, a_v, rank: int, dtype) -> None:
    H = a_q.shape[0]
    device = layer.qkv_kernel.device
    for name, value in (("lora_q_A", a_q), ("lora_q_B", np.zeros((rank, H), np.float32)),
                        ("lora_v_A", a_v), ("lora_v_B", np.zeros((rank, H), np.float32))):
        layer.register_parameter(name, nn.Parameter(  # a copy: no two share storage
            torch.tensor(value, device=device, dtype=dtype)))


def add_lora_t5(tower, rank: int = 8, seed=0):
    """Adapters of ``rank`` on a ``t5.T5Model``'s encoder q and v, in place; returns the
    tower. ``A`` is drawn N(0, 1) x d_model^-0.5 with ``np.random.default_rng(seed)``, q's
    ``[L, d_model, r]`` first, then v's; ``B`` is zero. The storage dtype is that of the
    encoder's matrices."""
    if has_lora(tower):
        raise ValueError("the tower already has LoRA adapters")
    enc = tower.encoder
    L, D, I = enc.attn_q.shape
    rng = np.random.default_rng(seed)
    std = np.float32(D ** -0.5)
    a_q = rng.standard_normal((L, D, rank), dtype=np.float32) * std
    a_v = rng.standard_normal((L, D, rank), dtype=np.float32) * std
    _add_stacked(enc, a_q, a_v, rank, I)
    return tower


def _add_stacked(enc, a_q, a_v, rank, inner):
    L = a_q.shape[0]
    zeros = np.zeros((L, rank, inner), np.float32)
    for name, value in (("lora_q_A", a_q), ("lora_q_B", zeros), ("lora_v_A", a_v),
                        ("lora_v_B", zeros)):
        enc.register_parameter(name, nn.Parameter(torch.tensor(
            value, device=enc.attn_q.device, dtype=enc.attn_q.dtype)))


def add_lora(tower, rank: int = 8, seed=0):
    """Add adapters of ``rank`` to every layer of a ``bert.BertEncoder``, in place;
    returns the tower. ``A`` is drawn with ``np.random.default_rng(seed)`` (an int
    or a sequence of ints): all q layers' ``[L, H, r]`` first, then all v layers',
    as the reference draws one stacked leaf each. The adapters take the storage
    dtype of the tower's matrices. A ``t5.T5Model`` takes :func:`add_lora_t5`."""
    if isinstance(tower, T5Model):
        return add_lora_t5(tower, rank, seed)
    if has_lora(tower):
        raise ValueError("the tower already has LoRA adapters")
    L, H = len(tower.layers), tower.config.hidden_size
    rng = np.random.default_rng(seed)
    std = np.float32(H ** -0.5)
    a_q = rng.standard_normal((L, H, rank), dtype=np.float32) * std
    a_v = rng.standard_normal((L, H, rank), dtype=np.float32) * std
    for i, layer in enumerate(tower.layers):
        _add_layer_adapters(layer, a_q[i], a_v[i], rank, layer.qkv_kernel.dtype)
    return tower


def add_lora_shaped(tower, rank: int):
    """Zero adapters of ``rank`` on every layer, to be filled by ``load_state_dict``
    (a checkpoint that holds them)."""
    if isinstance(tower, T5Model):
        L, D, I = tower.encoder.attn_q.shape
        zeros = np.zeros((L, D, rank), np.float32)
        _add_stacked(tower.encoder, zeros, zeros, rank, I)
        return tower
    H = tower.config.hidden_size
    zeros = np.zeros((H, rank), np.float32)
    for layer in tower.layers:
        _add_layer_adapters(layer, zeros, zeros, rank, layer.qkv_kernel.dtype)
    return tower


def has_lora(module: nn.Module) -> bool:
    """True when any layer below ``module`` carries adapters."""
    return any(name.rsplit(".", 1)[-1] == "lora_q_A" for name, _ in module.named_parameters())


def is_trainable(name: str) -> bool:
    """``lora_mask``'s rule on a parameter name: an adapter, or a parameter of a
    projection head (``head_q``, ``head_p``, ``head``)."""
    parts = name.split(".")
    return any(p.startswith("lora_") for p in parts) or any(p in HEADS for p in parts)


def lora_trainable(model: nn.Module) -> List[nn.Parameter]:
    """The parameters that train under LoRA, in ``model.parameters()`` order; every
    other parameter gets ``requires_grad_(False)``, so autograd leaves it without a
    gradient and no optimizer step can move it."""
    out = []
    for name, prm in model.named_parameters():
        if is_trainable(name):
            out.append(prm)
        else:
            prm.requires_grad_(False)
    return out


@torch.no_grad()
def merge_lora(tower):
    """Fold the adapters into the fused projection (``merge_lora``, the deploy-format
    export), in place; returns the tower. ``q += A_q B_q`` and ``v += A_v B_v`` in
    fp32, then rounded to the storage dtype; the adapters are removed, so the
    merged layers take the fused path again. A T5 tower raises: the reference has no
    T5 merge (its ``merge_lora`` reads ``layers``, lora.py:88)."""
    if isinstance(tower, T5Model):
        raise ValueError("merge_lora: T5 towers have no merge, as in the reference "
                         "(ROADMAP queue 3, findings)")
    H = tower.config.hidden_size
    for layer in tower.layers:
        if getattr(layer, "lora_q_A", None) is None:
            continue
        kernel = layer.qkv_kernel.float()
        kernel[:, :H] += layer.lora_q_A.float() @ layer.lora_q_B.float()
        kernel[:, 2 * H:] += layer.lora_v_A.float() @ layer.lora_v_B.float()
        layer.qkv_kernel.copy_(kernel)
        for name in LORA_KEYS:
            delattr(layer, name)
    return tower


def merge_lora_tree(tree):
    """:func:`merge_lora` on a reference-layout numpy tree (``models/convert.py``):
    a new tree whose ``q_kernel`` / ``v_kernel`` hold the folded adapters, in fp32. A T5
    tree raises, as :func:`merge_lora` does."""
    if "layers" not in tree:
        raise ValueError("merge_lora_tree: T5 towers have no merge, as in the reference "
                         "(ROADMAP queue 3, findings)")
    layers = dict(tree["layers"])
    if "lora_q_A" not in layers:
        return tree
    for side in ("q", "v"):
        a = np.asarray(layers.pop(f"lora_{side}_A"), np.float32)
        b = np.asarray(layers.pop(f"lora_{side}_B"), np.float32)
        layers[f"{side}_kernel"] = np.asarray(layers[f"{side}_kernel"], np.float32) + a @ b
    return {**tree, "layers": layers}

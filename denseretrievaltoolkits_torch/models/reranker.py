"""Cross-encoder reranker.

Counterpart of ``denseretrievaltoolkits_tpu/models/reranker.py`` (:1-285): one
tower scores joined (query, passage) pairs.

- ``bert`` (the port's BERT on the xla block, as the reference: it passes no
  ``attention``) and ``t5`` (the T5 encoder) pool the hidden states (``first`` or
  ``mean``) and project them with a bias-free ``LinearHead(hidden, 1)``: [B, 1];
- ``t5_full`` reads the step-0 decoder logits at the ``neg_token`` and
  ``pos_token`` ids: [B, 2], and always trains with the 2-way CE loss (:56-57).

``forward(pos_pairs, neg_pairs)`` adds the pairwise loss (mr / smr / bce / ce,
``train/losses.py``), broadcasting each positive over its query's negatives when
there are n_neg = r x n_pos of them (:134-142). ``save`` writes the reference's
layout (``weights.npz`` of the tower's tree, its config, the head's
``linear.npz``, ``openmatch_config.json``); ``build`` reads that (from either
package), an architecture-only directory, a local HF directory or a config.
Token ids come from the tokenizer (``encode(token, add_special_tokens=False)[0]``).
Parameters are fp32 masters cast to the compute dtype at use, on the CUDA card
unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..parallel.mesh import gathered
from ..train.losses import rr_loss_functions
from . import bert, linear
from .biencoder import (BACKBONES, DTYPES, MANIFEST, device_batch, hidden_size,
                        load_tower_config, make_tower, save_tower_config, source_tree)
from .convert import load_jax_params, params_from_jax, params_to_jax, save_jax_params
from .pooling import pool


@dataclass(frozen=True)
class RRModelSpec:
    """Static reranker configuration (the reference ``RRModelSpec``)."""

    bert_config: object  # BertConfig, or T5Config for backbones t5 / t5_full
    feature: str = "last_hidden_state"
    pooling: str = "first"
    pos_token: Optional[str] = None
    neg_token: Optional[str] = None
    pos_token_id: Optional[int] = None
    neg_token_id: Optional[int] = None
    loss_fn: str = "mr"
    margin: float = 1.0
    dtype: str = "float32"
    remat: str = ""
    backbone: str = "bert"  # "bert" | "t5" (encoder-only) | "t5_full" (token scoring)

    def __post_init__(self):
        if self.backbone not in BACKBONES:
            raise ValueError(f"Unknown backbone: {self.backbone}")
        if self.loss_fn not in rr_loss_functions:
            raise ValueError(f"Unknown reranker loss: {self.loss_fn!r} (one of "
                             f"{sorted(rr_loss_functions)})")


class RRModel(nn.Module):
    """The reranker: ``lm`` (a ``bert.BertEncoder`` or ``t5.T5Model``) and, except for
    ``t5_full``, ``head``."""

    def __init__(self, spec: RRModelSpec, device=None):
        super().__init__()
        # a full-T5 token-scoring reranker always trains with the 2-way CE loss
        if spec.backbone == "t5_full":
            spec = dataclasses.replace(spec, loss_fn="ce")
        self.spec = spec
        self.loss_fn = rr_loss_functions[spec.loss_fn]
        self.device = resolve_device(device, type(self).__name__)
        self.lm = make_tower(spec.bert_config, spec.backbone, DTYPES[spec.dtype], self.device,
                             torch.float32, remat=spec.remat)
        self.head = None
        if spec.backbone != "t5_full":
            self.head = linear.LinearHead(hidden_size(spec.bert_config), 1, device=self.device)

    def encode(self, items) -> torch.Tensor:
        """Scores of joined (q, d) pairs (a batch dict of numpy arrays or tensors), with
        autograd: [B, 1] through the head (``bert``, ``t5``), or the [neg, pos] token
        logits [B, 2] (``t5_full``); fp32 (reranker.py:100-130)."""
        spec = self.spec
        b = device_batch(items, self.device)
        hidden = self.lm(b["input_ids"], b["attention_mask"], b.get("token_type_ids"))
        if spec.backbone == "t5_full":
            if spec.pos_token_id is None or spec.neg_token_id is None:
                raise ValueError("t5_full scoring needs pos_token_id and neg_token_id (give "
                                 "build a tokenizer and pos_token / neg_token)")
            logits = self.lm.decode_step0(hidden, b["attention_mask"])
            return logits[:, [spec.neg_token_id, spec.pos_token_id]]
        if spec.pooling not in ("first", "mean"):
            raise ValueError(f"Unknown pooling type: {spec.pooling}")
        reps = pool(hidden, b["attention_mask"], spec.pooling).float()
        return self.head(reps)

    @torch.inference_mode()
    def score(self, items) -> torch.Tensor:
        """:meth:`encode` without autograd (the evaluation's scoring)."""
        return self.encode(items)

    def forward(self, pos_pairs=None, neg_pairs=None) -> Dict[str, torch.Tensor]:
        """Pairwise training forward (reranker.py:111-142): ``pos_pair_scores``, and with
        ``neg_pairs`` ``neg_pair_scores`` and the loss, each positive repeated over its
        query's negatives when their count is a multiple of the positives'."""
        out: Dict[str, torch.Tensor] = {}
        pos_scores = self.encode(pos_pairs) if pos_pairs is not None else None
        if pos_pairs is not None:
            out["pos_pair_scores"] = pos_scores
        if neg_pairs is None:
            return out
        neg_scores = self.encode(neg_pairs)
        out["neg_pair_scores"] = neg_scores
        n_pos, n_neg = pos_scores.shape[0], neg_scores.shape[0]
        pos_b = pos_scores
        if n_neg % n_pos == 0 and n_neg != n_pos:
            pos_b = pos_scores.repeat_interleave(n_neg // n_pos, dim=0)
        if pos_b.shape == neg_scores.shape:
            out["loss"] = self.loss_fn(pos_b, neg_scores, self.spec.margin)
        return out

    # -- persistence --------------------------------------------------------------------------

    def _manifest(self) -> Dict:
        spec = self.spec
        return {"plm_backbone": {"type": spec.backbone, "feature": spec.feature},
                "pooling": spec.pooling, "pos_token": spec.pos_token,
                "neg_token": spec.neg_token}

    def save(self, output_dir: str) -> None:
        """The reference's layout (reranker.py:155-164): ``weights.npz``, the tower's
        config, the head (not for ``t5_full``), ``openmatch_config.json``. A tower cut
        over a mesh's model axis is gathered first, on every rank, and global rank 0
        writes."""
        with gathered(self) as writer:
            if not writer:
                return
            os.makedirs(output_dir, exist_ok=True)
            save_jax_params(params_to_jax(self.lm.state_dict()), output_dir)
            save_tower_config(self.spec.bert_config, output_dir)
            if self.head is not None:
                linear.save_head(self.head, output_dir)
            with open(os.path.join(output_dir, MANIFEST), "w") as fh:
                json.dump(self._manifest(), fh, indent=4)

    def load_tree(self, tree: Dict, head: Optional[linear.LinearHead] = None) -> None:
        """Load a reference-layout tower tree (and a head's kernel)."""
        self.lm.load_state_dict(params_from_jax(tree))
        if head is not None:
            self.head.load_state_dict(head.state_dict())

    @classmethod
    def build(cls, model_args, data_args=None, train_args=None, tokenizer=None,
              bert_config: Optional[bert.BertConfig] = None, device=None,
              seed: int = 0) -> "RRModel":
        """From a directory either package saved (``openmatch_config.json``), an
        architecture-only directory (``t5_config.json``: ``t5`` with ``encoder_only``,
        else ``t5_full``; ``bert_config.json``), a local HF directory (BERT, or T5 by
        its ``config.json``), or random init from ``bert_config`` (reranker.py:166-285).
        Random weights from ``init_params_numpy(seed)`` (``t5.init_params_numpy``), a
        random head from ``linear.init_head`` seeded (seed, 1). ``loss_fn`` and
        ``margin`` come from ``train_args``; the token ids from ``tokenizer``. A hub id
        raises, as ``DRModel.build``: it needs a download. The model lives on
        ``device``: the CUDA card unless the caller names another."""
        path = model_args.model_name_or_path
        loss_fn = getattr(train_args, "loss_fn", "mr") if train_args else "mr"
        margin = getattr(train_args, "margin", 1.0) if train_args else 1.0

        def tok_id(token):
            if token is None or tokenizer is None:
                return None
            return tokenizer.encode(token, add_special_tokens=False)[0]

        common = dict(loss_fn=loss_fn, margin=margin,
                      dtype=getattr(model_args, "dtype", "float32"),
                      remat=getattr(model_args, "remat", ""))
        if path and os.path.isdir(path) and os.path.exists(os.path.join(path, MANIFEST)):
            with open(os.path.join(path, MANIFEST)) as fh:
                manifest = json.load(fh)
            backbone = manifest["plm_backbone"].get("type", "bert")
            pos_tok, neg_tok = manifest.get("pos_token"), manifest.get("neg_token")
            spec = RRModelSpec(
                bert_config=load_tower_config(backbone, path), backbone=backbone,
                feature=manifest["plm_backbone"]["feature"], pooling=manifest["pooling"],
                pos_token=pos_tok, neg_token=neg_tok, pos_token_id=tok_id(pos_tok),
                neg_token_id=tok_id(neg_tok), **common)
            model = cls(spec, device=device)
            model.load_tree(load_jax_params(path),
                            linear.load_head(path) if backbone != "t5_full" else None)
            return model

        backbone, tree, config = source_tree(model_args, bert_config, seed)
        spec = RRModelSpec(
            bert_config=config, backbone=backbone, feature=model_args.feature,
            pooling=model_args.pooling, pos_token=model_args.pos_token,
            neg_token=model_args.neg_token, pos_token_id=tok_id(model_args.pos_token),
            neg_token_id=tok_id(model_args.neg_token), **common)
        model = cls(spec, device=device)
        # the head maps pooled hidden states to one score: its input is the tower's width
        model.load_tree(tree, linear.init_head(hidden_size(config), 1, (seed, 1))
                        if backbone != "t5_full" else None)
        return model

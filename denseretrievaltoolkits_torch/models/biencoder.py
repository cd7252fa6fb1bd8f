"""DPR-style dual encoder, encode-only half.

Counterpart of ``denseretrievaltoolkits_tpu/models/biencoder.py``: tied or
untied BERT towers, optional bias-free head, first/mean/max pooling, optional
L2 normalization, and ``DRModel.build`` from a directory the JAX package saved
(``openmatch_config.json`` + ``weights.npz``, biencoder.py:244-280), so a
retriever trained there is served here unchanged. The contrastive-loss
branch of ``forward`` and HF-hub loading wait for the training port.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from . import bert, linear
from .convert import init_params_numpy, load_jax_params, params_from_jax
from .pooling import l2_normalize, pool

MANIFEST = "openmatch_config.json"

DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class DRModelSpec:
    """Static model configuration (the reference ``DRModelSpec`` minus the
    training-only fields)."""

    bert_config: bert.BertConfig
    tied: bool = True
    feature: str = "last_hidden_state"
    pooling: str = "first"
    linear_head: bool = False
    normalize: bool = False
    dtype: str = "float32"
    backbone: str = "bert"
    attention: str = "xla"

    def __post_init__(self):
        if self.pooling not in ("first", "mean", "max"):
            raise ValueError(f"Unknown pooling type: {self.pooling}")
        if self.backbone in ("t5", "t5_full"):
            raise NotImplementedError(
                "T5 towers are not ported yet (ROADMAP queue 1, item 'T5 and reranker')")
        if self.backbone != "bert":
            raise ValueError(f"Unknown backbone: {self.backbone}")
        if self.attention not in bert.ATTENTIONS:
            raise ValueError(f"Unknown attention impl: {self.attention}")


class DRModel(nn.Module):
    """Dual encoder. ``encode_query`` / ``encode_passage`` take a batch dict of
    ``input_ids`` / ``attention_mask`` (and optionally ``token_type_ids``), as
    numpy arrays or tensors, and return fp32 reps [B, D] on the model's device."""

    def __init__(self, spec: DRModelSpec, device=None, head_dims=None):
        super().__init__()
        self.spec = spec
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        dtype = DTYPES[spec.dtype]

        def tower():
            return bert.BertEncoder(spec.bert_config, dtype, spec.attention, device=self.device)

        self.lm_q = tower()
        self.lm_p = None if spec.tied else tower()
        self.head_q = self.head_p = None
        if spec.linear_head:
            in_dim, out_dim = head_dims or (spec.bert_config.hidden_size,) * 2
            self.head_q = linear.LinearHead(in_dim, out_dim, device=self.device)
            if not spec.tied:
                self.head_p = linear.LinearHead(in_dim, out_dim, device=self.device)

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for key in ("input_ids", "attention_mask", "token_type_ids"):
            v = batch.get(key)
            if v is not None:
                t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
                out[key] = t.to(self.device, torch.long)
        return out

    @torch.inference_mode()
    def _encode(self, lm: bert.BertEncoder, head, batch) -> torch.Tensor:
        spec = self.spec
        b = self._batch(batch)
        hidden = lm(b["input_ids"], b["attention_mask"], b.get("token_type_ids"))
        if spec.feature == "pooler_output":
            reps = lm.pooler(hidden)
        else:
            reps = pool(hidden, b["attention_mask"], spec.pooling)
        if head is not None:
            reps = head(reps)
        reps = reps.float()
        if spec.normalize:
            reps = l2_normalize(reps)
        return reps

    def encode_query(self, query) -> torch.Tensor:
        return self._encode(self.lm_q, self.head_q, query)

    def encode_passage(self, passage) -> torch.Tensor:
        if self.spec.tied:
            return self._encode(self.lm_q, self.head_q, passage)
        return self._encode(self.lm_p, self.head_p, passage)

    def encode_only_forward(self, query=None, passage=None) -> Dict[str, torch.Tensor]:
        """Reps, never a loss (the reference ``DRModelForInference`` contract)."""
        out = {}
        if query is not None:
            out["q_reps"] = self.encode_query(query)
        if passage is not None:
            out["p_reps"] = self.encode_passage(passage)
        return out

    def load_jax_tower(self, tower: str, tree: Dict) -> None:
        """Load a JAX BERT pytree (numpy) into ``lm_q`` or ``lm_p``."""
        getattr(self, tower).load_state_dict(params_from_jax(tree))

    @classmethod
    def build(cls, model_args, bert_config: Optional[bert.BertConfig] = None,
              device=None, seed: int = 0) -> "DRModel":
        """From a saved JAX-package checkpoint dir, an architecture-only dir
        (``bert_config.json``, random init), or random init from
        ``bert_config``. Random weights come from ``init_params_numpy(seed)``."""
        path = model_args.model_name_or_path
        dtype = getattr(model_args, "dtype", "float32")
        attention = getattr(model_args, "attention", "xla")
        if path and os.path.isdir(path) and os.path.exists(os.path.join(path, MANIFEST)):
            with open(os.path.join(path, MANIFEST)) as fh:
                manifest = json.load(fh)
            tied = manifest["tied"]
            qdir = path if tied else os.path.join(path, "query_model")
            heads = None
            if manifest["linear_head"]:
                heads = [linear.load_head(path if tied else os.path.join(path, "query_head"))]
                if not tied:
                    heads.append(linear.load_head(os.path.join(path, "passage_head")))
            spec = DRModelSpec(
                bert_config=bert.load_config(qdir), tied=tied,
                backbone=manifest["plm_backbone"].get("type", "bert"),
                feature=manifest["plm_backbone"]["feature"], pooling=manifest["pooling"],
                linear_head=manifest["linear_head"], normalize=manifest["normalize"],
                dtype=dtype, attention=attention)
            model = cls(spec, device=device,
                        head_dims=tuple(heads[0].kernel.shape) if heads else None)
            model.load_jax_tower("lm_q", load_jax_params(qdir))
            if not tied:
                model.load_jax_tower("lm_p", load_jax_params(os.path.join(path, "passage_model")))
            if heads:
                model.head_q.load_state_dict(heads[0].state_dict())
                if not tied:
                    model.head_p.load_state_dict(heads[1].state_dict())
            return model

        if path and os.path.isdir(path) and os.path.exists(os.path.join(path, "bert_config.json")) \
                and not os.path.exists(os.path.join(path, "weights.npz")):
            config = bert.load_config(path)
        elif path:
            raise NotImplementedError(
                f"{path!r} is not a checkpoint saved by the JAX package; HF checkpoints wait "
                f"for ROADMAP queue 1, item 'LoRA and HF import/export'")
        else:
            config = bert_config or bert.BertConfig()
        spec = DRModelSpec(
            bert_config=config, tied=not model_args.untie_encoder, feature=model_args.feature,
            pooling=model_args.pooling, linear_head=model_args.add_linear_head,
            normalize=model_args.normalize, dtype=dtype, attention=attention)
        if spec.linear_head:
            raise NotImplementedError(
                "random-init linear heads are a training concern (ROADMAP queue 1, "
                "item 'Training'); load a saved checkpoint instead")
        model = cls(spec, device=device)
        tree = init_params_numpy(config, seed)
        model.load_jax_tower("lm_q", tree)
        if model.lm_p is not None:
            model.load_jax_tower("lm_p", tree)
        return model


class DRModelForInference(DRModel):
    """Encode-only variant: ``forward`` never computes a loss."""

    def forward(self, query=None, passage=None):
        return self.encode_only_forward(query, passage)

"""DPR-style dual encoder.

Counterpart of ``denseretrievaltoolkits_tpu/models/biencoder.py``: tied or
untied BERT or T5 towers, optional bias-free head, first/mean/max pooling, optional
L2 normalization; ``DRModel.forward(query, passage)`` with the in-batch
contrastive loss (plain, or the fused K3/K4 kernels with ``fused_loss``);
``DRModel.build`` from a directory the JAX package saved (``openmatch_config.json``
+ ``weights.npz``, biencoder.py:244-280), an architecture-only directory or a
config (seeded random init); and ``save`` in that same layout, which the JAX
package loads; a local HF directory, read without ``transformers``
(``models/hf_import.py``), and ``export_hf`` to one. LoRA adapters
(``models/lora.py``) with ``param_efficient_method='lora'``.

Backbone ``t5`` is a T5 encoder tower pooled like BERT's; ``t5_full`` takes the
decoder's step-0 state as the rep (``models/t5.py``; biencoder.py:96-111 there).
Either comes from an architecture-only directory (``t5_config.json``), a local HF
T5 directory (``encoder_only`` picks ``t5``) or a directory either package saved.
``attention`` applies to BERT towers only and is ignored for T5, as in the
reference; T5 towers have no ``export_hf`` (the reference writes BERT keys only).

``DRModel`` trains: matrices are fp32 master parameters cast to the compute
dtype at use. ``DRModelForInference`` serves: it stores them in the compute
dtype (the cast is then a no-op) and never computes a loss.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..parallel.mesh import gathered
from ..train.losses import contrastive_loss
from . import bert, hf_import, linear, lora, t5
from .convert import (init_params_numpy, is_t5_tree, load_jax_params, params_from_jax,
                      params_to_jax, save_jax_params)
from .pooling import l2_normalize, pool

MANIFEST = "openmatch_config.json"

DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}
BACKBONES = ("bert", "t5", "t5_full")


def device_batch(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host ids -> int64 device tensors (``input_ids``, ``attention_mask`` and, when
    given, ``token_type_ids``). To a card they go from pinned memory without
    blocking, so the host never waits here for queued work."""
    out = {}
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        v = batch.get(key)
        if v is not None:
            t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            t = t.long()
            if device.type == "cuda" and not t.is_cuda:
                t = t.pin_memory()
            out[key] = t.to(device, non_blocking=True)
    return out


def make_tower(config, backbone: str, dtype: torch.dtype, device, param_dtype,
               attention: str = "xla", remat: str = ""):
    """A ``bert.BertEncoder`` or, for ``t5`` / ``t5_full``, a ``t5.T5Model`` (with its
    decoder for ``t5_full``; ``attention`` does not apply to it)."""
    if backbone in ("t5", "t5_full"):
        return t5.T5Model(config, dtype, device=device, param_dtype=param_dtype, remat=remat,
                          with_decoder=backbone == "t5_full")
    return bert.BertEncoder(config, dtype, attention, device=device, param_dtype=param_dtype,
                            remat=remat)


def hidden_size(config) -> int:
    return config.d_model if isinstance(config, t5.T5Config) else config.hidden_size


def save_tower_config(config, path: str) -> None:
    """``t5_config.json`` or ``bert_config.json``, by the config's kind."""
    (t5.save_config if isinstance(config, t5.T5Config) else bert.save_config)(config, path)


def load_tower_config(backbone: str, path: str):
    return (t5.load_config if backbone in ("t5", "t5_full") else bert.load_config)(path)


@dataclass(frozen=True)
class DRModelSpec:
    """Static model configuration (the reference ``DRModelSpec``)."""

    bert_config: object  # BertConfig, or T5Config for backbones t5 / t5_full
    tied: bool = True
    feature: str = "last_hidden_state"
    pooling: str = "first"
    linear_head: bool = False
    normalize: bool = False
    dtype: str = "float32"
    remat: str = ""
    backbone: str = "bert"
    fused_loss: bool = False  # K3/K4 fused similarity + CE (ops/contrastive.py)
    attention: str = "xla"

    def __post_init__(self):
        if self.pooling not in ("first", "mean", "max"):
            raise ValueError(f"Unknown pooling type: {self.pooling}")
        if self.backbone not in BACKBONES:
            raise ValueError(f"Unknown backbone: {self.backbone}")
        if self.attention not in bert.ATTENTIONS:
            raise ValueError(f"Unknown attention impl: {self.attention}")
        if self.remat not in bert.REMATS:
            raise ValueError(f"Unknown remat: {self.remat!r} (one of {bert.REMATS})")


class DRModel(nn.Module):
    """Dual encoder. ``encode_query`` / ``encode_passage`` take a batch dict of
    ``input_ids`` / ``attention_mask`` (and optionally ``token_type_ids``), as
    numpy arrays or tensors, and return fp32 reps [B, D] on the model's device,
    under ``inference_mode``. ``forward(query, passage)`` encodes with autograd
    and adds the contrastive loss."""

    serving = False  # True: matrices stored in the compute dtype

    def __init__(self, spec: DRModelSpec, device=None, head_dims=None):
        super().__init__()
        self.spec = spec
        self.device = resolve_device(device, type(self).__name__)
        dtype = DTYPES[spec.dtype]
        param_dtype = dtype if self.serving else torch.float32

        def tower():
            return make_tower(spec.bert_config, spec.backbone, dtype, self.device, param_dtype,
                              spec.attention, spec.remat)

        self.lm_q = tower()
        self.lm_p = None if spec.tied else tower()
        self.head_q = self.head_p = None
        if spec.linear_head:
            in_dim, out_dim = head_dims or (hidden_size(spec.bert_config),) * 2
            self.head_q = linear.LinearHead(in_dim, out_dim, device=self.device)
            if not spec.tied:
                self.head_p = linear.LinearHead(in_dim, out_dim, device=self.device)

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return device_batch(batch, self.device)

    @torch.inference_mode()
    def _encode(self, lm, head, batch) -> torch.Tensor:
        return self._reps(lm, head, batch)

    def _reps(self, lm, head, batch) -> torch.Tensor:
        spec = self.spec
        b = self._batch(batch)
        hidden = lm(b["input_ids"], b["attention_mask"], b.get("token_type_ids"))
        if spec.backbone == "t5_full":
            # the decoder's step-0 state (reference biencoder.py:101-106)
            reps = lm.decode_step0(hidden, b["attention_mask"], return_logits=False)
        elif spec.backbone == "bert" and spec.feature == "pooler_output":
            reps = lm.pooler(hidden)
        else:
            reps = pool(hidden, b["attention_mask"], spec.pooling)
        if head is not None:
            reps = head(reps)
        reps = reps.float()
        if spec.normalize:
            reps = l2_normalize(reps)
        return reps

    def _towers(self, side):
        if side == "query" or self.spec.tied:
            return self.lm_q, self.head_q
        return self.lm_p, self.head_p

    def encode_query(self, query) -> torch.Tensor:
        return self._encode(*self._towers("query"), query)

    def encode_passage(self, passage) -> torch.Tensor:
        return self._encode(*self._towers("passage"), passage)

    def forward(self, query=None, passage=None) -> Dict[str, torch.Tensor]:
        """Encode (with autograd) and, when both sides are given, add the
        in-batch contrastive loss (reference biencoder.py:143-170): fp32
        reps; ``"scores"`` only on the plain loss (the fused kernels never
        build them)."""
        out: Dict[str, torch.Tensor] = {}
        if query is not None:
            out["q_reps"] = self._reps(*self._towers("query"), query)
        if passage is not None:
            out["p_reps"] = self._reps(*self._towers("passage"), passage)
        if query is None or passage is None:
            return out
        loss, scores = self.loss(out["q_reps"], out["p_reps"])
        out["loss"] = loss
        if scores is not None:
            out["scores"] = scores
        return out

    def loss(self, q_reps: torch.Tensor, p_reps: torch.Tensor):
        """The in-batch contrastive loss of reps: (loss, scores), scores None
        on the fused path (K3 / K4 with ``fused_loss`` where P % Q == 0)."""
        if self.spec.fused_loss:
            from ..ops.contrastive import contrastive_loss_auto

            return contrastive_loss_auto(q_reps, p_reps)
        return contrastive_loss(q_reps, p_reps)

    def encode_only_forward(self, query=None, passage=None) -> Dict[str, torch.Tensor]:
        """Reps, never a loss (the reference ``DRModelForInference`` contract)."""
        out = {}
        if query is not None:
            out["q_reps"] = self.encode_query(query)
        if passage is not None:
            out["p_reps"] = self.encode_passage(passage)
        return out

    def _manifest(self) -> Dict:
        """The reference's manifest schema (biencoder.py:174-183)."""
        spec = self.spec
        return {"tied": spec.tied,
                "plm_backbone": {"type": spec.backbone, "feature": spec.feature},
                "pooling": spec.pooling, "linear_head": spec.linear_head,
                "normalize": spec.normalize, "dtype": spec.dtype}

    def save(self, output_dir: str) -> None:
        """Save in the reference's layout (biencoder.py:185-207): tied towers
        at the top, untied ones under ``query_model/`` and ``passage_model/``,
        heads (``query_head/``, ``passage_head/`` when untied), the
        ``bert_config.json`` (or ``t5_config.json``) of each tower and
        ``openmatch_config.json``. Towers cut over a mesh's model axis are
        gathered first, on every rank of the world, and global rank 0 writes."""
        with gathered(self) as writer:
            if writer:
                self._save(output_dir)

    def _save(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)

        def tower(lm, path):
            save_jax_params(params_to_jax(lm.state_dict()), path)
            save_tower_config(self.spec.bert_config, path)

        if self.spec.tied:
            tower(self.lm_q, output_dir)
            if self.spec.linear_head:
                linear.save_head(self.head_q, output_dir)
        else:
            tower(self.lm_q, os.path.join(output_dir, "query_model"))
            tower(self.lm_p, os.path.join(output_dir, "passage_model"))
            if self.spec.linear_head:
                linear.save_head(self.head_q, os.path.join(output_dir, "query_head"))
                linear.save_head(self.head_p, os.path.join(output_dir, "passage_head"))
        with open(os.path.join(output_dir, MANIFEST), "w") as fh:
            json.dump(self._manifest(), fh, indent=4)

    def add_lora(self, rank: int, seed: int = 0) -> None:
        """Adapters of ``rank`` on every tower layer (``models/lora.py``; a T5 tower's
        encoder q / v), drawn from (seed, 2), as the reference folds its key
        (biencoder.py:341-347); untied towers start from the same adapters (:350)."""
        for lm in (self.lm_q, self.lm_p):
            if lm is not None:
                lora.add_lora(lm, rank, seed=(seed, 2))

    def load_tower_tree(self, tower: str, tree: Dict) -> None:
        """Load a reference-layout tree into ``lm_q`` or ``lm_p``; a tree with LoRA
        leaves gives the tower adapters of their rank first."""
        lm = getattr(self, tower)
        layers = tree["encoder"] if is_t5_tree(tree) else tree["layers"]
        if "lora_q_A" in layers and not lora.has_lora(lm):
            lora.add_lora_shaped(lm, int(np.asarray(layers["lora_q_A"]).shape[-1]))
        lm.load_state_dict(params_from_jax(tree))

    def export_hf(self, output_dir: str) -> None:
        """The towers in the HF deploy format (``config.json`` + ``model.safetensors``,
        biencoder.py:209-219 there): tied to ``output_dir``, untied to ``query_model/``
        and ``passage_model/``. Adapters are merged into the exported weights first
        (``merge_lora_tree``); the model itself keeps them. The reference drops them
        here (ROADMAP queue 3, findings). T5 towers raise: the reference exports BERT
        keys only (hf_import.py:92 there). Cut towers are gathered first, as in
        :meth:`save`."""
        if self.spec.backbone != "bert":
            raise ValueError(f"export_hf: a {self.spec.backbone} tower has no HF export, as in "
                             f"the reference (ROADMAP queue 3, findings)")

        def tower(lm, path):
            tree = lora.merge_lora_tree(params_to_jax(lm.state_dict()))
            hf_import.save_pretrained_hf(tree, self.spec.bert_config, path)

        with gathered(self) as writer:
            if not writer:
                return
            if self.spec.tied:
                tower(self.lm_q, output_dir)
            else:
                tower(self.lm_q, os.path.join(output_dir, "query_model"))
                tower(self.lm_p, os.path.join(output_dir, "passage_model"))

    @classmethod
    def build(cls, model_args, bert_config: Optional[bert.BertConfig] = None,
              device=None, seed: int = 0) -> "DRModel":
        """From a saved checkpoint dir (either package's ``save``), an
        architecture-only dir (``bert_config.json`` or ``t5_config.json``, random
        init), a local HF directory (``config.json`` + ``model.safetensors`` or
        ``pytorch_model.bin``, read without ``transformers``: ``models/hf_import.py``;
        BERT, or T5 by its ``model_type``), or random init from ``bert_config``. A T5
        source builds backbone ``t5`` with ``encoder_only``, else ``t5_full``
        (biencoder.py:296-316 there). Random weights come from ``init_params_numpy(seed)``
        (``t5.init_params_numpy`` for T5);
        random heads (``add_linear_head``) from ``linear.init_head`` seeded with
        (seed, 1, 0) and, untied, (seed, 1, 1), as the reference folds its key
        (biencoder.py:351-359). ``param_efficient_method='lora'`` adds adapters of
        ``lora_rank`` drawn from (seed, 2) on every path (not on ``t5_full``, which the
        reference leaves without); a checkpoint that holds
        adapters reloads with them. From a checkpoint without adapters the
        reference ignores 'lora' (biencoder.py:280) and trains every parameter; the
        port adds them there too (ROADMAP queue 3, findings). A hub id raises: it
        needs a download. The model lives on ``device``: the CUDA card unless the
        caller names another (without a card that raises)."""
        path = model_args.model_name_or_path
        dtype = getattr(model_args, "dtype", "float32")
        attention = getattr(model_args, "attention", "xla")
        training = dict(remat=getattr(model_args, "remat", ""),
                        fused_loss=getattr(model_args, "fused_loss", False))
        rank = getattr(model_args, "lora_rank", 8) \
            if getattr(model_args, "param_efficient_method", None) == "lora" else 0
        if path and os.path.isdir(path) and os.path.exists(os.path.join(path, MANIFEST)):
            with open(os.path.join(path, MANIFEST)) as fh:
                manifest = json.load(fh)
            tied = manifest["tied"]
            backbone = manifest["plm_backbone"].get("type", "bert")
            qdir = path if tied else os.path.join(path, "query_model")
            heads = None
            if manifest["linear_head"]:
                heads = [linear.load_head(path if tied else os.path.join(path, "query_head"))]
                if not tied:
                    heads.append(linear.load_head(os.path.join(path, "passage_head")))
            spec = DRModelSpec(
                bert_config=load_tower_config(backbone, qdir), tied=tied, backbone=backbone,
                feature=manifest["plm_backbone"]["feature"], pooling=manifest["pooling"],
                linear_head=manifest["linear_head"], normalize=manifest["normalize"],
                dtype=dtype, attention=attention, **training)
            model = cls(spec, device=device,
                        head_dims=tuple(heads[0].kernel.shape) if heads else None)
            model.load_tower_tree("lm_q", load_jax_params(qdir))
            if not tied:
                model.load_tower_tree("lm_p", load_jax_params(os.path.join(path, "passage_model")))
            if heads:
                model.head_q.load_state_dict(heads[0].state_dict())
                if not tied:
                    model.head_p.load_state_dict(heads[1].state_dict())
            if rank and backbone != "t5_full" and not lora.has_lora(model):
                model.add_lora(rank, seed)
            return model

        backbone, tree, config = source_tree(model_args, bert_config, seed)
        spec = DRModelSpec(
            bert_config=config, tied=not model_args.untie_encoder, backbone=backbone,
            feature=model_args.feature, pooling=model_args.pooling,
            linear_head=model_args.add_linear_head, normalize=model_args.normalize,
            dtype=dtype, attention=attention, **training)
        dims = (model_args.projection_in_dim, model_args.projection_out_dim)
        model = cls(spec, device=device, head_dims=dims)
        model.load_tower_tree("lm_q", tree)
        if model.lm_p is not None:
            model.load_tower_tree("lm_p", tree)
        if spec.linear_head:
            for i, head in enumerate((model.head_q, model.head_p)):
                if head is not None:
                    head.load_state_dict(linear.init_head(*dims, (seed, 1, i)).state_dict())
        if rank and backbone != "t5_full":
            model.add_lora(rank, seed)
        return model


def source_tree(model_args, bert_config=None, seed: int = 0):
    """(backbone, reference-layout tree, config) of a source that is no saved checkpoint:
    an architecture-only dir (``t5_config.json`` or ``bert_config.json`` and no
    ``weights.npz``: seeded random init), a local HF directory (BERT or T5 by its
    ``config.json``), or ``bert_config`` (seeded random BERT). A T5 source is ``t5`` with
    ``encoder_only``, else ``t5_full`` with its decoder. A path that is no local
    directory raises in ``hf_import``: a hub id needs a download."""
    path = model_args.model_name_or_path
    t5_backbone = "t5" if getattr(model_args, "encoder_only", False) else "t5_full"
    arch_only = bool(path) and os.path.isdir(path) \
        and not os.path.exists(os.path.join(path, "weights.npz"))
    if arch_only and os.path.exists(os.path.join(path, "t5_config.json")):
        config = t5.load_config(path)
        return t5_backbone, t5.init_params_numpy(config, seed, t5_backbone == "t5_full"), config
    if arch_only and os.path.exists(os.path.join(path, "bert_config.json")):
        config = bert.load_config(path)
        return "bert", init_params_numpy(config, seed), config
    if path:
        if os.path.isdir(path) and isinstance(hf_import.read_config(path), t5.T5Config):
            tree, config = hf_import.params_from_pretrained(
                path, with_decoder=t5_backbone == "t5_full")
            return t5_backbone, tree, config
        tree, config = hf_import.params_from_pretrained(path)
        return "bert", tree, config
    config = bert_config or bert.BertConfig()
    return "bert", init_params_numpy(config, seed), config


class DRModelForInference(DRModel):
    """Encode-only variant: ``forward`` never computes a loss, and matrices
    are stored in the compute dtype."""

    serving = True

    def forward(self, query=None, passage=None):
        return self.encode_only_forward(query, passage)

"""The port's dual encoder built for a cell, through its public classes.

The configuration file's sizes become the port's ``BertConfig`` / ``T5Config``; the
cell's ``model`` block picks the attention path and the fused loss; the benchmark's
seeded weights (:mod:`harness.weights`) load into every tower by ``load_state_dict``, as
``DRModel.build`` loads one tree into both towers of an untied model.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .weights import make_weights


def tower_config(config: Dict):
    if config["model_type"] == "bert":
        from denseretrievaltoolkits_torch.models.bert import BertConfig

        keys = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "max_position_embeddings", "type_vocab_size",
                "layer_norm_eps", "pad_token_id", "initializer_range")
        return "bert", BertConfig(**{k: config[k] for k in keys})
    from denseretrievaltoolkits_torch.models.t5 import T5Config

    keys = ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads",
            "relative_attention_num_buckets", "layer_norm_epsilon", "pad_token_id")
    return "t5", T5Config(relative_attention_max_distance=config["assumed"][
        "relative_attention_max_distance"], tie_word_embeddings=True, is_gated_act=False,
        **{k: config[k] for k in keys})


def dual_encoder(run, serving: bool) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(the port's ``DRModelForInference`` (``serving``) or ``DRModel``, the fp32 weights
    it was loaded from)."""
    from denseretrievaltoolkits_torch.models.biencoder import (DRModel, DRModelForInference,
                                                               DRModelSpec)

    de = run.config["dual_encoder"]
    model_opts = run.workload.get("model", {})
    backbone, tcfg = tower_config(run.config)
    spec = DRModelSpec(bert_config=tcfg, tied=not de["untie_encoder"], pooling=de["pooling"],
                       normalize=de["normalize"], dtype=de["dtype"], backbone=backbone,
                       fused_loss=model_opts.get("fused_loss", False),
                       attention=model_opts.get("attention", "xla"))
    model = (DRModelForInference if serving else DRModel)(spec, device=run.device)
    weights = make_weights(run.config, run.seed, run.device)
    for tower in (model.lm_q, model.lm_p):
        if tower is not None:
            tower.load_state_dict(weights)
    return model, weights

"""The reference side of an encoder check: the plain float32 encoder of a configuration
(``reference/bert.py`` or ``reference/t5.py``) with its pooling, on the benchmark's
seeded weights, made again here rather than taken from the port."""

from __future__ import annotations

from typing import Dict

import torch

from reference import bert as ref_bert
from reference import t5 as ref_t5
from reference.precision import strict_fp32
from reference.train import pool

from .weights import make_weights


def encoder(config: Dict):
    """``encode(weights, ids, mask, cast)`` -> last hidden states, of the configuration."""
    if config["model_type"] == "bert":
        return lambda w, ids, mask, cast: ref_bert.encode(w, config, ids, mask, cast)
    dist = config["assumed"]["relative_attention_max_distance"]
    return lambda w, ids, mask, cast: ref_t5.encode(w, config, ids, mask, cast, dist)


def reps(run, batch: Dict, cast, block: int = 128) -> torch.Tensor:
    """The reference's pooled reps [n, H] float32 of a host batch, on the run's device,
    in blocks of ``block`` rows."""
    strict_fp32()
    weights = make_weights(run.config, run.seed, run.device)
    enc = encoder(run.config)
    how = run.config["dual_encoder"]["pooling"]
    out = []
    with torch.no_grad():
        for s in range(0, len(batch["input_ids"]), block):
            ids = torch.as_tensor(batch["input_ids"][s:s + block], device=run.device)
            mask = torch.as_tensor(batch["attention_mask"][s:s + block], device=run.device)
            out.append(pool(enc(weights, ids, mask, cast), mask, how))
    return torch.cat(out)

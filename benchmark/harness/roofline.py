"""The yardstick: the H100's published peaks and the work each cell's traffic asks for.

``bound`` is a frozen copy of ``chip_smoke.py:bound`` (commit 2b7f364), in seconds: the
least time the card could take for some work is the larger of its bytes (each input read
once, each output written once) over the memory bandwidth and its operations over the
peak rate of their type. Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.

The operation counts are computed from the shapes the traffic made, never from what a
kernel happens to run, so a later change of kernels leaves the work unchanged.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound(n_bytes: float, ops: float, kind: str = "bf16") -> float:
    """Seconds: max(bytes / HBM bandwidth, operations / peak of ``kind``)."""
    return max(n_bytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind])


def encoder_flops(layers: int, hidden: int, inner: int, ffn: int,
                  lengths: Iterable[int]) -> float:
    """Forward FLOPs of a post- or pre-LN transformer encoder over sequences of the given
    real (unpadded) lengths: per layer and sequence of L tokens, the q, k, v and output
    projections 2 L (4 H I), the feed-forward 2 L (2 H F), and the scores and the
    probabilities times the values 4 L^2 I. With I = H this is 2 L (4 H^2 + 2 H F) + 4 L^2 H.
    Norms, softmax and biases are left out."""
    L = np.asarray(list(lengths) if not isinstance(lengths, np.ndarray) else lengths,
                   dtype=np.float64)
    per_layer = 2.0 * L * (4.0 * hidden * inner + 2.0 * hidden * ffn) + 4.0 * L * L * inner
    return float(layers * per_layer.sum())


def contrastive_flops(queries: int, passages: int, hidden: int) -> float:
    """Forward FLOPs of the in-batch loss: the [Q, P] scores, 2 Q P H."""
    return 2.0 * queries * passages * hidden


def flat_search_bound_s(rows: int, dim: int, queries: int, row_bytes: float,
                        scale_bytes: float = 4.0) -> float:
    """Least seconds of one exact flat search: the 2 N H Q products at the bf16 peak,
    or the rows, their scales and the fp32 queries read once, whichever is longer."""
    n_bytes = rows * dim * row_bytes + rows * scale_bytes + queries * dim * 4.0
    return bound(n_bytes, 2.0 * rows * dim * queries, "bf16")


def model_dims(config) -> tuple:
    """(layers, hidden, attention inner width, feed-forward width) of a configuration."""
    if config["model_type"] == "bert":
        return (config["num_hidden_layers"], config["hidden_size"], config["hidden_size"],
                config["intermediate_size"])
    return (config["num_layers"], config["d_model"], config["num_heads"] * config["d_kv"],
            config["d_ff"])


def lengths_flops(config, lengths) -> float:
    """:func:`encoder_flops` of the configuration over a list of length arrays."""
    if not lengths:
        return 0.0
    return encoder_flops(*model_dims(config), np.concatenate(lengths))

"""Exact inner-product top-k over int8 rows, in plain float32.

The rows are quantized here from the float32 rows the benchmark makes (each row by its
absolute maximum over 127, rounded half to even, clipped to [-127, 127]; a zero row
keeps scale 1), and a query's score of a row is its float32 product with the row's
integer values, times the row's scale. Slabs of rows arrive one at a time; a running
top-k keeps, per query, the k best (score, id) pairs. It also
keeps the reference's score of every id the port returned, so the port's answers are
judged by the reference's own scores.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values float32 holding integers in [-127, 127], scales [rows] float32).

    The scale is absmax / 127 rounded once: the divisor is a tensor, because PyTorch's
    CUDA division by a Python number multiplies by its rounded reciprocal instead, which
    moves one scale in twenty by an ulp and flips codes that lie on a half."""
    absmax = x.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale[:, None]), -127, 127), scale


class ExactTopK:
    """The exact top-``k`` of float32 ``queries`` [Q, H] over slabs of rows, and the
    reference's scores of ``probe_ids`` [Q, k'] (the ids under judgement)."""

    def __init__(self, queries: torch.Tensor, k: int, probe_ids: torch.Tensor,
                 query_cast=None):
        self.q = queries.float() if query_cast is None else query_cast(queries.float())
        self.k = k
        self.probe = probe_ids.long()
        self.probe_scores = torch.full(self.probe.shape, float("nan"), device=self.q.device)
        Q = self.q.shape[0]
        self.top_s = torch.full((Q, 0), float("-inf"), device=self.q.device)
        self.top_i = torch.zeros((Q, 0), dtype=torch.long, device=self.q.device)

    def add_slab(self, start: int, rows: torch.Tensor) -> None:
        values, scale = quantize_int8(rows.float())
        s = torch.matmul(self.q, values.T) * scale[None, :]
        inside = (self.probe >= start) & (self.probe < start + rows.shape[0])
        local = torch.where(inside, self.probe - start, torch.zeros_like(self.probe))
        self.probe_scores = torch.where(inside, torch.gather(s, 1, local), self.probe_scores)
        ids = torch.arange(start, start + rows.shape[0], device=s.device).expand_as(s)
        cat_s = torch.cat([self.top_s, s], dim=1)
        cat_i = torch.cat([self.top_i, ids], dim=1)
        self.top_s, order = torch.topk(cat_s, min(self.k, cat_s.shape[1]), dim=1)
        self.top_i = torch.gather(cat_i, 1, order)

"""The numbers that decide ``correct``: each is a worst case over what the run checked,
so that one wrong answer is enough to fail its limit."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of ||got - want|| / ||want||; inf where ``got`` is not finite."""
    got, want = got.float(), want.float().to(got.device)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float(((got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-30)).max())


def topk_gaps(ref_scores: torch.Tensor, probe_scores: torch.Tensor, probe_ids: torch.Tensor,
              got_scores: torch.Tensor) -> Dict[str, float]:
    """The port's top-k against the reference's, per query relative to the width of the
    reference's top-k band (its first score less its k-th):

    - ``id_gap``: max over ranks of (the reference's r-th best score - the reference's
      score of the port's r-th id): 0 where the port returned the true top-k in order,
      about a band where an id is wrong;
    - ``score_err``: max |the port's score - the reference's score of that id|.

    A repeated or unknown id reads inf in both."""
    band = (ref_scores[:, 0] - ref_scores[:, -1]).clamp_min(1e-30)[:, None]
    ids = probe_ids.long()
    sorted_ids = torch.sort(ids, dim=1).values
    bad = bool((sorted_ids[:, 1:] == sorted_ids[:, :-1]).any()) \
        or not bool(torch.isfinite(probe_scores).all()) \
        or not bool(torch.isfinite(got_scores).all())
    if bad:
        return {"id_gap": math.inf, "score_err": math.inf}
    return {"id_gap": float(((ref_scores - probe_scores) / band).max()),
            "score_err": float(((got_scores.float() - probe_scores).abs() / band).max())}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Sequence[str] = None) -> Dict[str, float]:
    """Per leaf, |got - want| / max(want, the median leaf's want): norms of one quantity
    per leaf, the port's against the reference's (inf where the port's is not finite)."""
    names = list(want) if keep is None else list(keep)
    med = statistics.median(want[n] for n in names)
    return {n: abs(got.get(n, 0.0) - want[n]) / max(want[n], med, 1e-30)
            if math.isfinite(got.get(n, 0.0)) else math.inf for n in names}



def moved_leaves(grad_norms: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient is at least ``share`` of the median leaf's: the
    others (a key bias under softmax, an unused pooler) move under Adam by rounding alone."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= share * med]


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    """max over steps of |got - want| / |want|."""
    worst = 0.0
    for g, w in zip(got, want):
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
    return worst

"""The in-batch contrastive step of a dual encoder, in plain float32.

DPR's loss (arXiv:2004.04906): each query's softmax cross-entropy over its scores
against every passage of the batch, the positive at passage ``i * P / Q``, averaged over
the queries. Reps: the CLS state (``first``) or the mean over the real tokens (``mean``).
Gradients by autograd; AdamW as ``torch.optim.AdamW`` defines it (Loshchilov and Hutter,
arXiv:1711.05101): decay ``p -= lr wd p``, then ``p -= lr m_hat / (sqrt(v_hat) + eps)``.

:func:`run_steps` follows a training run from its initial weights through its first
steps and reports each step's loss, each leaf's first gradient and each leaf's change
after the last step. ``half_batch`` plants a fault for the tests and the control: the
loss's mean over the first half of the queries only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from .precision import exact


def pool(hidden: torch.Tensor, mask: torch.Tensor, how: str) -> torch.Tensor:
    if how == "first":
        return hidden[:, 0]
    m = mask.to(hidden.dtype)[:, :, None]
    return (hidden * m).sum(dim=1) / m.sum(dim=1)


def contrastive_loss(q: torch.Tensor, p: torch.Tensor, cast=exact,
                     half_batch: bool = False) -> torch.Tensor:
    scores = torch.matmul(cast(q), cast(p).T)
    target = torch.arange(q.shape[0], device=q.device) * (p.shape[0] // q.shape[0])
    losses = torch.nn.functional.cross_entropy(scores, target, reduction="none")
    return losses[:q.shape[0] // 2].mean() if half_batch else losses.mean()


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, betas[0], betas[1], eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def run_steps(towers: Dict[str, Dict[str, torch.Tensor]], encode: Callable, pooling: str,
              batches: Sequence, lr: float, norms: Callable, cast=exact,
              half_batch: bool = False) -> Dict:
    """``towers``: {"lm_q": weights} (tied) or {"lm_q": ..., "lm_p": ...} (untied), each
    {leaf: float32 tensor}; ``encode(weights, ids, mask, cast)`` -> hidden states;
    ``batches``: [(query {"input_ids", "attention_mask"}, passage {...})]; ``norms``
    maps {tower.leaf: tensor} to {parameter: norm}. Returns {"losses": [float],
    "grad_norms": {parameter: float}, "change_norms": {parameter: float}}."""
    params = {f"{t}.{k}": v.detach().clone().float().requires_grad_(True)
              for t, w in towers.items() for k, v in w.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = AdamW(params, lr)
    side_q = "lm_q"
    side_p = "lm_p" if "lm_p" in towers else "lm_q"

    def tower(name):
        return {k[len(name) + 1:]: v for k, v in params.items() if k.startswith(name + ".")}

    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, (qb, pb) in enumerate(batches):
        q = pool(encode(tower(side_q), qb["input_ids"], qb["attention_mask"], cast),
                 qb["attention_mask"], pooling)
        p = pool(encode(tower(side_p), pb["input_ids"], pb["attention_mask"], cast),
                 pb["attention_mask"], pooling)
        loss = contrastive_loss(q, p, cast, half_batch)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        if step == 0:
            grad_norms = norms(grads)
        losses.append(float(loss.detach()))
        opt.step(params, grads)
        del q, p, loss, grads
    change = norms({n: params[n].detach() - start[n] for n in params})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

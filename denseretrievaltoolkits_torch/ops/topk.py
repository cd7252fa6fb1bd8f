"""Exact block top-J kernel K5 and the certified exact top-k search.

Counterparts of ``denseretrievaltoolkits_tpu/ops/topk.py``:

- :func:`block_topj` (K5, ``csrc/block_topj.cu``) ports ``_pallas_block_topj``:
  per (query, corpus block) the J best (score, id) pairs, ties to the smaller
  id. Its plain version is :func:`_block_topj_reference`. CPU tensors take the
  plain version; CUDA tensors launch the kernel or raise. Launches are counted
  in ``block_topj.launches``.
- :func:`certified_topk` ports ``pallas_topk`` (topk.py:638-770): candidates
  from K5, a merge, the exactness certificate, J x4 escalation for flagged
  queries, and the exact blockwise scan for whatever is still flagged. The
  scan is part of the algorithm's contract, not a device fallback; the
  queries that take it are counted in ``certified_topk.fallback_queries``
  (and those escalated in ``certified_topk.escalated_queries``).

The scan itself, ``blockwise_topk``, lives in ``index/flat.py`` as in the
reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _native


def _scores(q: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """fp32 scores of q against a corpus block: bf16 rows score bf16 queries
    (exact products, fp32 sums); fp32 rows score in true fp32."""
    if block.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    return torch.matmul(q.float(), block.float().T)


def _block_topj_reference(q, corpus, J: int, block_size: int, n_valid: int):
    """Plain version of K5: (vals [Q, n_blocks, J] fp32, ids [Q, n_blocks, J]
    int32). A block with fewer than J valid rows fills its tail with (-inf, -1)."""
    Q = q.shape[0]
    N = corpus.shape[0]
    n_blocks = -(-N // block_size)
    vals = torch.full((Q, n_blocks, J), float("-inf"), dtype=torch.float32, device=q.device)
    ids = torch.full((Q, n_blocks, J), -1, dtype=torch.int32, device=q.device)
    for b in range(n_blocks):
        start = b * block_size
        blk = corpus[start:start + block_size]
        s = _scores(q, blk)
        row = torch.arange(start, start + blk.shape[0], device=q.device)
        s = torch.where(row[None, :] < n_valid, s, float("-inf"))
        # stable descending sort: equal scores keep ascending ids
        sv, pos = torch.sort(s, dim=1, descending=True, stable=True)
        j = min(J, blk.shape[0])
        vals[:, b, :j] = sv[:, :j]
        ids[:, b, :j] = torch.where(sv[:, :j] == float("-inf"), -1,
                                    (pos[:, :j] + start)).to(torch.int32)
    return vals, ids


def block_topj(q: torch.Tensor, corpus: torch.Tensor, J: int, block_size: int,
               n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block top-J candidates (K5). q [Q,H] and corpus [N,H] share a dtype
    (float32 or bfloat16); rows >= n_valid are masked. Returns (vals
    [Q, n_blocks, J] fp32, ids [Q, n_blocks, J] int32), n_blocks = ceil(N/block)."""
    if not corpus.is_cuda:
        return _block_topj_reference(q, corpus, J, block_size, n_valid)
    Q, H = q.shape
    N = corpus.shape[0]
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_topj: the CUDA kernel takes float32 or bfloat16 rows, "
                        f"got {corpus.dtype}")
    if q.dtype != corpus.dtype or q.device != corpus.device or corpus.shape[1] != H:
        raise ValueError(f"block_topj: q {q.dtype} {tuple(q.shape)} on {q.device} does not "
                         f"match corpus {corpus.dtype} {tuple(corpus.shape)} on {corpus.device}")
    if not (1 <= J <= 32):
        raise ValueError(f"block_topj: the kernel keeps J <= 32 per block, got {J}")
    n_blocks = -(-N // block_size)
    if n_blocks > 65535:
        raise ValueError(f"block_topj: {n_blocks} blocks exceed the grid; raise block_size")
    q = q.contiguous()
    corpus = corpus.contiguous()
    vals = torch.empty((Q, n_blocks, J), dtype=torch.float32, device=q.device)
    ids = torch.empty((Q, n_blocks, J), dtype=torch.int32, device=q.device)
    if Q == 0 or N == 0:
        return vals, ids
    lib = _native.library()
    block_topj.launches += 1
    _native.check(lib.drt_block_topj(
        q.data_ptr(), corpus.data_ptr(), vals.data_ptr(), ids.data_ptr(), Q, N, H,
        int(n_valid), int(block_size), int(J), int(corpus.dtype == torch.bfloat16),
        _native.stream_ptr(q)), "drt_block_topj")
    return vals, ids


block_topj.launches = 0


def _merge(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of [Q, n_blocks, J] candidates, ties to the earlier (smaller-id)
    candidate as lax.top_k does, plus the per-query certificate: a block whose
    J-th value still reaches the merged k-th score may hide more top-k rows."""
    Q, nb, j = vals.shape
    flat_v = vals.reshape(Q, nb * j)
    flat_i = ids.reshape(Q, nb * j)
    kk = min(k, nb * j)
    sv, pos = torch.sort(flat_v, dim=1, descending=True, stable=True)
    top_v = sv[:, :kk]
    top_i = torch.gather(flat_i, 1, pos[:, :kk])
    theta = top_v[:, -1:]
    eps = 1e-6 * theta.abs() + 1e-30
    flagged = (vals[:, :, -1] >= theta - eps).any(dim=1)
    return top_v, top_i, flagged, kk


def certified_topk(q_reps: torch.Tensor, corpus: torch.Tensor, k: int,
                   block_size: int = 2048, J: Optional[int] = None,
                   valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k through K5 candidates and the certificate ladder.

    q_reps [Q,H] float; corpus [N,H] float32/bfloat16 on the same device.
    Returns (scores [Q,k'] fp32, ids [Q,k'] int32) sorted descending, with
    k' = min(k, rows). Counterpart of ``pallas_topk`` (topk.py:638-770)."""
    from ..index.flat import blockwise_topk

    N = corpus.shape[0]
    n_valid = int(N if valid is None else valid)
    if J is None:
        J = max(4, min(k, 8))
    J = min(J, k)
    q32 = q_reps.to(device=corpus.device, dtype=torch.float32)

    # small corpora: fewer candidate slots than k can represent — scan instead
    if -(-N // block_size) * J < min(k, n_valid):
        return blockwise_topk(q32, corpus, min(k, n_valid), min(block_size, N), valid=n_valid)

    qc = q32.to(corpus.dtype)
    vals, ids = block_topj(qc, corpus, J, block_size, n_valid)
    top_v, top_i, flagged, kk = _merge(vals, ids, k)
    if bool(flagged.any()) and 4 * J < k:
        idx = torch.nonzero(flagged).squeeze(1)
        certified_topk.escalated_queries += int(idx.numel())
        v2, i2 = block_topj(qc[idx], corpus, min(4 * J, k), block_size, n_valid)
        tv, ti, still, _ = _merge(v2, i2, kk)
        top_v[idx] = tv
        top_i[idx] = ti
        flagged = torch.zeros_like(flagged)
        flagged[idx[still]] = True
    if bool(flagged.any()):
        idx = torch.nonzero(flagged).squeeze(1)
        certified_topk.fallback_queries += int(idx.numel())
        s, i = blockwise_topk(q32[idx], corpus, kk, min(65536, N), valid=n_valid)
        top_v[idx] = s
        top_i[idx] = i
    return top_v, top_i


certified_topk.escalated_queries = 0
certified_topk.fallback_queries = 0

"""Block top-J kernels K5, K6, K8, K10, K11 and K12, the certified search and the serve search.

Counterparts of ``denseretrievaltoolkits_tpu/ops/topk.py``. Every kernel runs a
Hopper body at the shapes it takes (``csrc/flat_certified.cu``: K5, K8 over fp32
rows; ``csrc/flat_serve.cu``: K5 over bf16 rows, K6, K8 over bf16 and int8 rows,
K11, K12;
``csrc/int4_certified.cu``: K10), and one templated CUDA family
(``csrc/block_topj.cu``) at the others, where the call also counts on
``<counter>_generic`` (:func:`hopper_pair`); each has its own entry point,
launch counter and plain version. CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.

``int4=True`` selects the nibble-packed int4 rows of ``ops/quant.py`` (K9):
corpus [N, H/2] int8 in column halves with per-row ``scales``, queries [Q, H].
Each entry point then runs its sq4 twin: ``block_topj`` K10 (fp32 queries,
true-fp32 scores, ``block_topj.launches_int4``; on s8 wgmma with exact query
digits at H % 128 == 0, H <= 768 and 16-byte aligned rows, else on
``block_topj.cu``'s FFMA body, which also counts on
``block_topj.launches_int4_generic``), ``block_topj_serve`` K11
(bf16 queries, ``block_topj_serve.launches_int4``) and ``block_topj_i8q``
K12's sq4 body (int8 queries, exact s32 products,
``block_topj_i8q.launches_int4``). The plain versions score the reference's
two half-dim products (topk.py:166-258), then the scale. K11 and both K12
bodies run ``csrc/flat_serve.cu``'s wgmma bodies at H % 128 == 0 (int4 rows up
to 768, int8 up to 1024) with 16-byte aligned operands; at other shapes
``block_topj.cu``'s run them and the call also counts on
``<counter>_generic`` (``block_topj_serve.launches_int4_generic``,
``block_topj_i8q.launches_generic`` / ``launches_int4_generic``).

- :func:`block_topj` ports ``_pallas_block_topj`` (K5, fp32 / bf16 rows) and,
  given per-row ``scales`` for int8 rows, ``_pallas_block_topj_scaled`` (K6,
  bf16 queries): per (query, corpus block) the J best (score, id) pairs, ties
  to the smaller id. Plain version :func:`_block_topj_reference`; launches in
  ``block_topj.launches`` (K5) and ``block_topj.launches_int8`` (K6). K5 over
  fp32 rows runs ``csrc/flat_certified.cu``'s wgmma body (fp32 products as fp16
  pairs) at H % 64 == 0 up to 768, K5 over bf16 rows ``csrc/flat_serve.cu``'s
  (TMA + wgmma, the certified order) at H % 64 == 0 up to 1024, with 16-byte
  aligned rows, else ``block_topj.cu``'s, which also count on
  ``block_topj.launches_generic``; K6 ``flat_serve.cu``'s (int8 words into bf16
  wgmma fragments, the certified order) at H % 64 == 0 up to 1024, else
  ``block_topj.cu``'s, counted on ``block_topj.launches_int8_generic`` too.
  ``block_topj.last_body`` names the body of the last call.
- :func:`block_topj_serve` ports the serve kernels ``_block_topj_kernel_packed``
  / ``_packed_scaled`` (K8) over fp32, bf16 and int8 rows. The TPU packs score
  and id into one int32 and rounds the score; the kernel packs them into 64
  bits, so its scores are exact. Plain version
  :func:`_block_topj_serve_reference`; launches in ``block_topj_serve.launches``.
  fp32 rows run ``flat_certified.cu``'s fp16-pair body (H % 64 == 0 up to 768),
  bf16 and int8 rows ``flat_serve.cu``'s (H % 64 == 0 up to 1024), 16-byte
  aligned; other shapes ``block_topj.cu``'s, counted on
  ``block_topj_serve.launches_generic`` too.
- :func:`block_topj_i8q` ports ``_block_topj_kernel_packed_i8q`` (K12's int8
  body): int8 queries x int8 rows with s32 products, times scale_row x
  scale_query, then the serve selection. Plain version
  :func:`_block_topj_i8q_reference`; launches in ``block_topj_i8q.launches``.
- :func:`certified_topk` ports ``pallas_topk`` (topk.py:638-770): candidates
  from K5 / K6 / K10, a merge, the exactness certificate, J x4 escalation for
  flagged queries, and the exact blockwise scan for whatever is still
  flagged. The scan is part of the algorithm's contract, not a device
  fallback; the queries that take it are counted in
  ``certified_topk.fallback_queries`` (those escalated in
  ``certified_topk.escalated_queries``). ``certify=False`` returns the merged
  candidates as they are (the ``partial`` mode).
- :func:`serve_topk` ports ``pallas_topk_fast`` (topk.py:863-971): J from the
  Poisson rule, no certificate, K8 / K11 (or K12 with ``i8_native``), and the
  exact scan for tiny corpora only (:func:`serve_plan`).

As in the reference, int8 rows score bf16 queries in the kernels (topk.py:695,
:951) while the exact scan scores fp32 queries (``blockwise_topk``, as
index/flat.py:121-126 of the JAX package); int4 rows score fp32 queries in
both the certified kernel and the scan (topk.py:687-690). The scan itself
lives in ``index/flat.py``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _native
from .quant import quantize_queries, unpack_int4

JMAX = 32     # the kernels keep one list entry per lane
SERVE_J = 4   # the reference's floor for the serve J (topk.py:843)
TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
INT4_CODE = 3  # nibble-packed int4 rows, stored as int8 [N, H/2]


def _half_products(q: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """q [Q, H] against int4 rows [n, H/2]: the reference's two half-dim
    products (dims below H/2 against the low nibbles, the rest against the
    high ones), summed, in q's float type."""
    codes = unpack_int4(packed).to(q.dtype)
    half = codes.shape[1] // 2
    return (torch.matmul(q[:, :half], codes[:, :half].T)
            + torch.matmul(q[:, half:], codes[:, half:].T))


def _scores(q: torch.Tensor, block: torch.Tensor,
            scales: Optional[torch.Tensor] = None, int4: bool = False) -> torch.Tensor:
    """fp32 scores of q against a corpus block: bf16 rows score bf16 queries
    (exact products, fp32 sums); fp32 rows score in true fp32; int8 rows score
    the queries as given (the caller casts) times the per-row ``scales``;
    int4 rows (``int4``) the two half-dim products of the queries as given,
    times the ``scales``."""
    if int4:
        s = _half_products(q.float(), block)
    else:
        if block.dtype == torch.bfloat16:
            q = q.to(torch.bfloat16)
        s = torch.matmul(q.float(), block.float().T)
    return s if scales is None else s * scales[None, :]


def _per_block(score, select, Q: int, N: int, J: int, block_size: int, n_valid: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals [Q, n_blocks, J] fp32, ids [Q, n_blocks, J] int32) of ``select``
    over each block's ``score(start, stop)``. A block with fewer than J valid
    rows fills its tail with (-inf, -1)."""
    n_blocks = -(-N // block_size)
    vals = torch.full((Q, n_blocks, J), float("-inf"), dtype=torch.float32, device=device)
    ids = torch.full((Q, n_blocks, J), -1, dtype=torch.int32, device=device)
    for b in range(n_blocks):
        start = b * block_size
        stop = min(N, start + block_size)
        rows = torch.arange(start, stop, device=device)
        s = torch.where(rows[None, :] < n_valid, score(start, stop), float("-inf"))
        v, pos = select(s, rows, min(J, stop - start))
        j = v.shape[1]
        vals[:, b, :j] = v
        ids[:, b, :j] = torch.where(v == float("-inf"), -1, rows[pos]).to(torch.int32)
    return vals, ids


def _select_pairs(s, rows, j):
    """The j best (score, position) pairs: a stable descending sort keeps
    equal scores in ascending id order."""
    sv, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return sv[:, :j], pos[:, :j]


def _select_packed(s, rows, j):
    """The serve selection on packed keys, as the kernel: the reference's
    order-preserving int transform of the score bits (topk.py:104-105) high,
    the inverted row id low, one top-k on the int64 keys."""
    bits = s.contiguous().view(torch.int32).long()
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF) << 32
    key = key | (0xFFFFFFFF - rows)[None, :]
    key = torch.where(s == float("-inf"), torch.iinfo(torch.int64).min, key)
    _, pos = torch.topk(key, j, dim=1)
    return s.gather(1, pos), pos


def _rows_scorer(q, corpus, scales, int4=False):
    """score(start, stop) of q against corpus rows start..stop-1."""
    return lambda a, b: _scores(q, corpus[a:b], None if scales is None else scales[a:b], int4)


def _block_topj_reference(q, corpus, J: int, block_size: int, n_valid: int, scales=None,
                          int4: bool = False):
    """Plain version of K5, with ``scales`` of K6, and with ``int4`` of K10."""
    return _per_block(_rows_scorer(q, corpus, scales, int4), _select_pairs, q.shape[0],
                      corpus.shape[0], J, block_size, n_valid, q.device)


def _block_topj_serve_reference(q, corpus, J: int, block_size: int, n_valid: int,
                                scales=None, int4: bool = False):
    """Plain version of K8 and, with ``int4``, of K11: the same scores as K5 /
    K6 / K10, the packed-key selection."""
    return _per_block(_rows_scorer(q, corpus, scales, int4), _select_packed, q.shape[0],
                      corpus.shape[0], J, block_size, n_valid, q.device)


def _block_topj_i8q_reference(qi, qscales, corpus, scales, J: int, block_size: int,
                              n_valid: int, int4: bool = False):
    """Plain version of K12 (and, with ``int4``, of its sq4 body): s32
    products (exact in fp32 while H * 127 * 127 (int4: 127 * 7) < 2^24, else
    in fp64), dequantized as float(s32) * scale_row * scale_q."""
    wide = torch.float32 if qi.shape[1] * 127 * (7 if int4 else 127) < 2 ** 24 \
        else torch.float64
    qf = qi.to(wide)

    def score(a, b):
        if int4:
            s32 = _half_products(qf, corpus[a:b]).float()
        else:
            s32 = torch.matmul(qf, corpus[a:b].to(wide).T).float()
        return s32 * scales[None, a:b] * qscales[:, None]

    return _per_block(score, _select_packed, qi.shape[0], corpus.shape[0], J, block_size,
                      n_valid, qi.device)


# the bodies drt_block_topj reports it ran
BODIES = ("block_topj", "int4_certified", "flat_certified", "flat_serve")

# (query dtype, row dtype or "int4", serve) of the pairs a Hopper body takes at some shapes:
# certified K5 (fp32: flat_certified.cu; bf16: flat_serve.cu), K6 (flat_serve.cu), K10
# (int4_certified.cu); serve K8
# over fp32 (flat_certified.cu), bf16 and int8 rows, K11, K12 and its sq4 body (flat_serve.cu)
HOPPER_PAIRS = frozenset({
    (torch.float32, torch.float32, False), (torch.bfloat16, torch.bfloat16, False),
    (torch.bfloat16, torch.int8, False), (torch.float32, "int4", False),
    (torch.float32, torch.float32, True), (torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.int8, True), (torch.int8, torch.int8, True),
    (torch.bfloat16, "int4", True), (torch.int8, "int4", True)})


def hopper_pair(qtype, ctype, serve: bool, int4: bool) -> bool:
    """Whether a Hopper body takes (query dtype, row dtype) at some shapes, in the
    certified or the serve selection (``int4``: nibble-packed int8 rows): where it
    does, ``block_topj.cu``'s body running the call counts on ``<counter>_generic``."""
    if int4 and ctype != torch.int8:  # int4 rows are nibble-packed into int8
        return False
    return (qtype, "int4" if int4 else ctype, bool(serve)) in HOPPER_PAIRS


def _launch(wrapper, counter, q, corpus, J, block_size, n_valid, scales=None, qscales=None,
            serve=False, int4=False):
    """Check the operands and launch ``drt_block_topj``; returns (vals, ids).
    A launch adds one to ``wrapper.<counter>``, and to
    ``wrapper.<counter>_generic`` where the C entry reports that
    ``block_topj.cu``'s body ran a call whose pair a Hopper body takes at other
    shapes (:func:`hopper_pair`). ``wrapper.last_body`` names the body that
    ran."""
    name = wrapper.__name__
    Q, H = q.shape
    N = corpus.shape[0]
    if corpus.dtype not in TYPE_CODES or q.dtype not in TYPE_CODES:
        raise TypeError(f"{name}: the CUDA kernels take float32, bfloat16 or int8, got "
                        f"q {q.dtype}, corpus {corpus.dtype}")
    width = H // 2 if int4 else H
    if (q.device != corpus.device or corpus.ndim != 2 or corpus.shape[1] != width
            or (int4 and H % 2)):
        raise ValueError(f"{name}: q {tuple(q.shape)} on {q.device} does not match "
                         f"{'int4 ' if int4 else ''}corpus {tuple(corpus.shape)} on "
                         f"{corpus.device}")
    for what, s, n in (("scales", scales, N), ("query scales", qscales, Q)):
        if s is not None and (s.dtype != torch.float32 or s.shape != (n,) or
                              s.device != corpus.device):
            raise ValueError(f"{name}: {what} must be float32 [{n}] on {corpus.device}, got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")
    if not (1 <= J <= JMAX):
        raise ValueError(f"{name}: the kernel keeps J <= {JMAX} per block, got {J}")
    n_blocks = -(-N // block_size)
    if n_blocks > 65535:
        raise ValueError(f"{name}: {n_blocks} blocks exceed the grid; raise block_size")
    q = q.contiguous()
    corpus = corpus.contiguous()
    vals = torch.empty((Q, n_blocks, J), dtype=torch.float32, device=q.device)
    ids = torch.empty((Q, n_blocks, J), dtype=torch.int32, device=q.device)
    if Q == 0 or N == 0:
        return vals, ids
    lib = _native.library()
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    body = ctypes.c_int(0)
    _native.check(lib.drt_block_topj(
        q.data_ptr(), corpus.data_ptr(), 0 if scales is None else scales.data_ptr(),
        0 if qscales is None else qscales.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        Q, N, H, int(n_valid), int(block_size), int(J), TYPE_CODES[q.dtype],
        INT4_CODE if int4 else TYPE_CODES[corpus.dtype], int(serve), ctypes.byref(body),
        _native.stream_ptr(q)), "drt_block_topj")
    wrapper.last_body = BODIES[body.value]
    if body.value == 0 and hopper_pair(q.dtype, corpus.dtype, serve, int4):
        setattr(wrapper, counter + "_generic", getattr(wrapper, counter + "_generic") + 1)
    return vals, ids


def block_topj(q: torch.Tensor, corpus: torch.Tensor, J: int, block_size: int,
               n_valid: int, scales: Optional[torch.Tensor] = None, int4: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block top-J candidates. K5: q [Q,H] and corpus [N,H] share a dtype
    (float32 or bfloat16). K6: corpus int8 with ``scales`` [N] fp32, q
    bfloat16. K10 (``int4``): corpus packed int4 [N, H/2] with ``scales``, q
    float32. Rows >= n_valid are masked. Returns (vals [Q, n_blocks, J] fp32,
    ids [Q, n_blocks, J] int32), n_blocks = ceil(N / block_size)."""
    if not corpus.is_cuda:
        return _block_topj_reference(q, corpus, J, block_size, n_valid, scales, int4)
    if int4:
        if scales is None or q.dtype != torch.float32 or corpus.dtype != torch.int8:
            raise ValueError("block_topj: int4 rows (packed int8) take per-row scales and "
                             "float32 queries")
        return _launch(block_topj, "launches_int4", q, corpus, J, block_size, n_valid, scales,
                       int4=True)
    if corpus.dtype == torch.int8:
        if scales is None or q.dtype != torch.bfloat16:
            raise ValueError("block_topj: int8 rows take per-row scales and bfloat16 queries")
        counter = "launches_int8"
    else:
        if scales is not None or q.dtype != corpus.dtype:
            raise ValueError(f"block_topj: float rows take queries of their dtype and no "
                             f"scales; got q {q.dtype}, corpus {corpus.dtype}")
        counter = "launches"
    return _launch(block_topj, counter, q, corpus, J, block_size, n_valid, scales)


block_topj.launches = 0
block_topj.launches_generic = 0
block_topj.launches_int8 = 0
block_topj.launches_int8_generic = 0
block_topj.launches_int4 = 0
block_topj.launches_int4_generic = 0
block_topj.last_body = None


def block_topj_serve(q: torch.Tensor, corpus: torch.Tensor, J: int, block_size: int,
                     n_valid: int, scales: Optional[torch.Tensor] = None, int4: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serve-mode per-block top-J (K8; K11 with ``int4``): the J best rows of
    each block, ties to the smaller id, exact scores. Rows fp32 or bf16 with
    queries of their dtype, or int8 (or packed int4 [N, H/2]) with ``scales``
    and bf16 queries. Layout as ``block_topj``."""
    if not corpus.is_cuda:
        return _block_topj_serve_reference(q, corpus, J, block_size, n_valid, scales, int4)
    quantized = corpus.dtype == torch.int8
    want = torch.bfloat16 if quantized else corpus.dtype
    if q.dtype != want or (scales is None) != (not quantized) or (int4 and not quantized):
        raise ValueError(f"block_topj_serve: {'int4' if int4 else corpus.dtype} rows take "
                         f"{want} queries{' and per-row scales' if quantized else ''}; "
                         f"got q {q.dtype}, scales {scales is not None}")
    return _launch(block_topj_serve, "launches_int4" if int4 else "launches", q, corpus, J,
                   block_size, n_valid, scales, serve=True, int4=int4)


block_topj_serve.launches = 0
block_topj_serve.launches_generic = 0
block_topj_serve.last_body = None
block_topj_serve.launches_int4 = 0
block_topj_serve.launches_int4_generic = 0


def block_topj_i8q(qi: torch.Tensor, qscales: torch.Tensor, corpus: torch.Tensor,
                   scales: torch.Tensor, J: int, block_size: int, n_valid: int,
                   int4: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Native-int8 per-block top-J (K12; its sq4 body with ``int4``): qi [Q,H]
    int8 with ``qscales`` [Q], corpus [N,H] int8 (or packed int4 [N, H/2])
    with ``scales`` [N]; the serve selection. The kernel takes H % 64 == 0
    with 16-byte aligned rows."""
    if not corpus.is_cuda:
        return _block_topj_i8q_reference(qi, qscales, corpus, scales, J, block_size, n_valid,
                                         int4)
    if qi.dtype != torch.int8 or corpus.dtype != torch.int8:
        raise TypeError(f"block_topj_i8q: takes int8 queries and rows, got {qi.dtype}, "
                        f"{corpus.dtype}")
    H = qi.shape[1]
    if H % 64:
        raise ValueError(f"block_topj_i8q: the s8 tensor-core kernel takes H % 64 == 0, got "
                         f"H={H}")
    if qi.data_ptr() % 16 or corpus.data_ptr() % 16:
        raise ValueError("block_topj_i8q: the kernel takes 16-byte aligned rows")
    return _launch(block_topj_i8q, "launches_int4" if int4 else "launches", qi, corpus, J,
                   block_size, n_valid, scales, qscales, serve=True, int4=int4)


block_topj_i8q.launches = 0
block_topj_i8q.launches_generic = 0
block_topj_i8q.last_body = None
block_topj_i8q.launches_int4 = 0
block_topj_i8q.launches_int4_generic = 0


def _top(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of [Q, n_blocks, J] candidates, ties to the earlier (smaller-id)
    candidate as lax.top_k does."""
    Q, nb, j = vals.shape
    flat_v = vals.reshape(Q, nb * j)
    sv, pos = torch.sort(flat_v, dim=1, descending=True, stable=True)
    kk = min(k, nb * j)
    return sv[:, :kk], torch.gather(ids.reshape(Q, nb * j), 1, pos[:, :kk])


def _merge(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """The merged top-k plus the per-query certificate: a block whose J-th
    value still reaches the merged k-th score may hide more top-k rows."""
    top_v, top_i = _top(vals, ids, k)
    theta = top_v[:, -1:]
    eps = 1e-6 * theta.abs() + 1e-30
    flagged = (vals[:, :, -1] >= theta - eps).any(dim=1)
    return top_v, top_i, flagged, top_v.shape[1]


def _check_quantized(name, corpus, scales, int4):
    if (corpus.dtype == torch.int8) != (scales is not None):
        raise ValueError(f"{name}: int8 / int4 rows, and only they, take per-row scales")
    if int4 and corpus.dtype != torch.int8:
        raise ValueError(f"{name}: int4 rows are packed into int8 [N, H/2], got {corpus.dtype}")


def certified_topk(q_reps: torch.Tensor, corpus: torch.Tensor, k: int,
                   block_size: int = 2048, J: Optional[int] = None,
                   valid: Optional[int] = None, scales: Optional[torch.Tensor] = None,
                   certify: bool = True, int4: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k through K5 (K6 for int8 rows with ``scales``, K10 for
    packed int4 rows with ``int4``) candidates and the certificate ladder;
    ``certify=False`` stops after the merge.

    q_reps [Q,H] float; corpus [N,H] float32/bfloat16/int8 (int4: [N, H/2])
    on the same device. Returns (scores [Q,k'] fp32, ids [Q,k'] int32) sorted
    descending, with k' = min(k, rows). Counterpart of ``pallas_topk``
    (topk.py:638-770)."""
    from ..index.flat import blockwise_topk

    N = corpus.shape[0]
    n_valid = int(N if valid is None else valid)
    _check_quantized("certified_topk", corpus, scales, int4)
    if J is None:
        J = max(4, min(k, 8))
    J = min(J, k)
    q32 = q_reps.to(device=corpus.device, dtype=torch.float32)

    # small corpora: fewer candidate slots than k can represent — scan instead
    if -(-N // block_size) * J < min(k, n_valid):
        return blockwise_topk(q32, corpus, min(k, n_valid), min(block_size, N), valid=n_valid,
                              scales=scales, int4=int4)

    # int4 rows score fp32 queries (topk.py:690), int8 rows bf16 ones (:695)
    if int4:
        qc = q32
    else:
        qc = q32.to(torch.bfloat16 if corpus.dtype == torch.int8 else corpus.dtype)
    vals, ids = block_topj(qc, corpus, J, block_size, n_valid, scales, int4)
    top_v, top_i, flagged, kk = _merge(vals, ids, k)
    if not certify:
        return top_v, top_i
    if bool(flagged.any()) and 4 * J < k:
        idx = torch.nonzero(flagged).squeeze(1)
        certified_topk.escalated_queries += int(idx.numel())
        v2, i2 = block_topj(qc[idx], corpus, min(4 * J, k), block_size, n_valid, scales, int4)
        tv, ti, still, _ = _merge(v2, i2, kk)
        top_v[idx] = tv
        top_i[idx] = ti
        flagged = torch.zeros_like(flagged)
        flagged[idx[still]] = True
    if bool(flagged.any()):
        idx = torch.nonzero(flagged).squeeze(1)
        certified_topk.fallback_queries += int(idx.numel())
        s, i = blockwise_topk(q32[idx], corpus, kk, min(65536, N), valid=n_valid, scales=scales,
                              int4=int4)
        top_v[idx] = s
        top_i[idx] = i
    return top_v, top_i


certified_topk.escalated_queries = 0
certified_topk.fallback_queries = 0


def serve_j(k: int, n_blocks: int, block_size: int) -> int:
    """The serve J (topk.py:894-900): the true top-k members landing in one
    block are ~Poisson(k / n_blocks), so mean + 4 sqrt + 4 slots keep the
    per-block overflow below ~1e-6; at least ``SERVE_J``."""
    lam = k / n_blocks
    J = max(SERVE_J, int(math.ceil(lam + 4.0 * math.sqrt(lam) + 4.0)))
    return min(J, k, block_size)


def serve_plan(k: int, N: int, n_valid: int, block_size: int) -> Optional[Tuple[int, int]]:
    """(block, J) of the serve kernels over N rows, or None for the exact scan.

    The scan takes corpora with fewer than two blocks of ``block_size``, or
    whose candidate slots cannot hold k: the reference's tiny-corpus rule
    (topk.py:901-909), and its only one. The reference lets J grow to k; the
    kernels keep J <= 32 per block, so the block halves while the Poisson J
    exceeds 32. That always ends, since J <= block, and the slots still hold
    k: n_blocks * J >= k, or J = block and every row is a candidate."""
    block = max(1, min(block_size, N))
    J = serve_j(k, -(-N // block), block)
    if -(-N // block) * J < min(k, n_valid) or N < 2 * block:
        return None
    while J > JMAX:
        block //= 2
        J = serve_j(k, -(-N // block), block)
    return block, J


def serve_topk(q_reps: torch.Tensor, corpus: torch.Tensor, k: int, block_size: int = 2048,
               scales: Optional[torch.Tensor] = None, valid: Optional[int] = None,
               i8_native: bool = False, int4: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near-exact serving search, the counterpart of ``pallas_topk_fast``: K8
    (K11 for packed int4 rows with ``int4``) candidates with J from the
    Poisson rule and a merge, no certificate. ``i8_native`` (int8 / int4
    rows): queries quantize with K7 and score on K12 (its sq4 body for int4).
    Block and J as :func:`serve_plan`. Returns (scores [Q,k'], ids [Q,k'])."""
    from ..index.flat import blockwise_topk

    N = corpus.shape[0]
    n_valid = int(N if valid is None else valid)
    _check_quantized("serve_topk", corpus, scales, int4)
    if i8_native and corpus.dtype != torch.int8:
        raise ValueError(f"serve_topk: i8_native needs int8 or int4 rows, got {corpus.dtype}")
    q32 = q_reps.to(device=corpus.device, dtype=torch.float32)
    plan = serve_plan(k, N, n_valid, block_size)
    if plan is None:
        return blockwise_topk(q32, corpus, min(k, n_valid), max(1, min(block_size, N)),
                              valid=n_valid, scales=scales, int4=int4)
    block, J = plan
    if i8_native:
        qi, qs = quantize_queries(q32)
        vals, ids = block_topj_i8q(qi, qs, corpus, scales, J, block, n_valid, int4)
    else:
        qc = q32.to(torch.bfloat16 if corpus.dtype == torch.int8 else corpus.dtype)
        vals, ids = block_topj_serve(qc, corpus, J, block, n_valid, scales, int4)
    return _top(vals, ids, min(k, n_valid))

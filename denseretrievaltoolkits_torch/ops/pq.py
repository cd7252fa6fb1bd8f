"""Product quantization: training, encode, decode, exact ADC, and the serve kernels K15 and K16.

Counterpart of ``denseretrievaltoolkits_tpu/ops/pq.py``. A row of H dims is
cut into M subspaces of ``d_sub = H / M`` dims; each subspace stores the id
of its nearest codebook entry, so a row takes M bytes (8-bit codes, 256
entries per subspace) or M / 2 bytes (4-bit codes, 16 entries).

Layouts, the reference's:

- codes, CODE-MAJOR: 8-bit ``[M, N]`` int8 holding ``code - 128``; 4-bit
  ``[M / 2, N]`` int8, subspace 2i in the low nibble of packed row i and 2i+1
  in the high nibble (the byte wraps to int8). Column n holds row n's codes.
- codebooks ``[M, k, d_sub]`` fp32.
- ``bdcb`` ``[H / 128, 128, G * k]`` bf16 (G = 128 / d_sub): the
  block-diagonal expansion the TPU decodes with one-hot matmuls
  (:func:`build_bdcb`); :func:`build_bdcb_i8` its int8 twin with one scale
  per output dim.

Helpers, plain PyTorch on any device: :func:`pq_train` (M batched k-means,
initial rows and empty-entry re-seeds drawn by numpy from ``seed`` in the
reference's call order, sums by ``index_add_``), :func:`pq_encode_device`
(the argmax of ``x.c - |c|^2 / 2`` in fp32), :func:`pq_decode`,
:func:`pq_blockwise_topk` (exact ADC: true-fp32 scores against the
reconstructions). fp32 products on CUDA must not use TF32.

The serve kernels (``csrc/pq_serve.cu``) decode each block once per search,
as the TPU kernel does, then score it on the tensor cores. The corpus goes
through in chunks of whole storage blocks (:func:`pq_chunk_rows`); per chunk
a decode pass writes the chunk's rows, bf16 [rows, H], into a scratch the
wrapper allocates (the codes gather, per code byte, that subspace's ``d_sub``
entries of a compact table ``[M, k, d_sub]``, which :func:`bdcb_table` cuts
out of ``bdcb``), then a wgmma + TMA body scores bf16(q) against the decoded
rows with fp32 sums, masks rows >= n_valid and keeps each block's J best rows
with the 64-bit serve selection (exact scores). Two launches a chunk, counted
per launch: the decode pass in ``pq_topj_blocks.launches_decode``, the
scoring body in the counter of its kernel:

- K15 (:func:`pq_topj_blocks`, bf16 table; ``_pq_serve_kernel`` and
  ``_pq4_serve_kernel``, pq.py:349, :409): each decoded value is one bf16
  codebook entry, as the TPU's one-hot matmul yields. Scoring launches in
  ``pq_topj_blocks.launches`` (8-bit) and ``.launches_4bit``.
- K16 (the same wrapper given ``scale``; ``_pq_serve_kernel_i8dec``,
  pq.py:293): an int8 table and one fp32 scale per output dim; each decoded
  value is bf16(float(entry) x scale[dim]), rounded once, which is what the
  TPU's s8 x s8 -> s32 one-hot decode yields (it sums one entry). Scoring
  launches in ``pq_topj_blocks.launches_i8dec``.

Plain versions :func:`_pq_decode_reference` (a chunk's decoded rows) and
:func:`_pq_topj_reference` (chunk by chunk under the same plan); CPU tensors
take them, CUDA tensors launch the kernels or raise. :func:`pq_serve_topk` is
the serve search (``pallas_topk_pq_fast``, pq.py:553-588): the Poisson J, the
kernels' J <= 32 by halving the block (``ops/topk.py:serve_plan``), and the
exact scan for tiny corpora only, counted in ``pq_serve_topk.exact_scans``. The TPU rounds serve
scores to 2^id_bits ulps in its packed selection; these come back exact.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _native
from .topk import JMAX, _per_block, _select_packed, _top, serve_plan

K = 256         # entries per subspace of the 8-bit codes (FAISS's PQ{M} default)
PQ_BLOCK = 512  # the serve search's default corpus block (pq.py:548)
# rows of one decode chunk of the serve kernels (rounded to whole blocks): 48 MB of
# decoded rows at H = 768, most of which the 50 MB L2 still holds when they are scored
PQ_CHUNK_ROWS = 32768
# elements of one [M, rows, k] score chunk of the encoder
_ENCODE_CHUNK = 1 << 27


def _check_fp32(t: torch.Tensor, what: str) -> None:
    """fp32 products on CUDA must be true fp32, as the reference's."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what}: fp32 scores must not use TF32; set "
                           f"torch.backends.cuda.matmul.allow_tf32 = False")


def _as_tensor(x, device=None) -> torch.Tensor:
    """fp32 rows on ``device`` (default: where they are; numpy on the CPU)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)) if isinstance(x, np.ndarray) \
        else torch.as_tensor(x)
    return t.to(device=t.device if device is None else device, dtype=torch.float32)


# -- training -------------------------------------------------------------------------------------


def _kmeans_step(x_sub: torch.Tensor, cb: torch.Tensor, block_rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration of all M subspace k-means at once (pq.py:61-92):
    x_sub [M, n, d], cb [M, k, d] -> (new cb, counts [M, k]). Rows past the
    last whole ``block_rows`` block take no part, as in the reference; an
    entry no row chose keeps its value."""
    M, n, d = x_sub.shape
    k = cb.shape[1]
    _check_fp32(x_sub, "pq_train")
    half = 0.5 * (cb * cb).sum(2)
    offs = (torch.arange(M, device=cb.device) * k)[:, None]
    sums = torch.zeros((M * k, d), dtype=torch.float32, device=cb.device)
    counts = torch.zeros(M * k, dtype=torch.float32, device=cb.device)
    for start in range(0, (n // block_rows) * block_rows, block_rows):
        xb = x_sub[:, start:start + block_rows]
        s = torch.bmm(xb, cb.transpose(1, 2))
        s.sub_(half[:, None, :])
        flat = (torch.argmax(s, dim=2) + offs).reshape(-1)
        sums.index_add_(0, flat, xb.reshape(-1, d))
        counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    sums, counts = sums.view(M, k, d), counts.view(M, k)
    new = torch.where(counts[..., None] > 0, sums / counts.clamp(min=1.0)[..., None], cb)
    return new, counts


def pq_train(sample, M: int, iters: int = 12, seed: int = 0, block_rows: int = 2048,
             k: int = K, device=None) -> np.ndarray:
    """Train M subspace codebooks of ``k`` entries (256: 8-bit codes, 16:
    4-bit) on sample rows [n, H] (host or device), on ``device`` (default:
    the sample's). Returns codebooks [M, k, d_sub] fp32 (pq.py:95-137): the
    initial entries are sample rows drawn by ``default_rng(seed)``, and after
    each iteration the entries no row chose re-seed from fresh random rows
    of the same generator, subspace by subspace."""
    x = _as_tensor(sample, device)
    n, H = x.shape
    if M <= 0 or H % M:
        raise ValueError(f"dim {H} not divisible by M={M}")
    d = H // M
    n = (n // block_rows) * block_rows
    if n < block_rows or n == 0:
        raise ValueError(f"PQ training needs >= {block_rows} sample rows, got {x.shape[0]}")
    x_sub = x[:n].reshape(n, M, d).permute(1, 0, 2).contiguous()  # [M, n, d]
    rng = np.random.default_rng(seed)
    init_rows = rng.choice(n, size=k, replace=n < k)
    cb = x_sub[:, torch.from_numpy(init_rows).to(x.device)]
    for _ in range(iters):
        cb, counts = _kmeans_step(x_sub, cb, block_rows)
        counts_h = counts.cpu().numpy()
        n_empty = int((counts_h == 0).sum())
        if n_empty:
            cb_h = cb.cpu().numpy()
            rows = rng.choice(n, size=n_empty, replace=n < n_empty)
            x_h = x_sub.cpu().numpy()
            ptr = 0
            for m in range(M):
                empty = np.where(counts_h[m] == 0)[0]
                if empty.size:
                    cb_h[m, empty] = x_h[m, rows[ptr:ptr + empty.size] % n]
                    ptr += empty.size
            cb = torch.from_numpy(cb_h).to(x.device)
    return cb.cpu().numpy()


# -- encode / decode ------------------------------------------------------------------------------


def pq4_unpack(codes: torch.Tensor) -> torch.Tensor:
    """Nibble codes [M/2, n] int8 -> [M, n] int64 in 0..15: subspace 2i from
    the low nibble of packed row i, 2i+1 from the high one (pq.py:145-150)."""
    v = codes.to(torch.int64) & 255
    return torch.stack([v & 15, v >> 4], dim=1).reshape(2 * codes.shape[0], codes.shape[1])


def _code_ids(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Stored codes -> entry ids [M, n] int64."""
    return pq4_unpack(codes) if k <= 16 else codes.to(torch.int64) + 128


def pq_encode_device(reps: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Encode reps [n, H] against codebooks [M, k, d] (pq.py:153-170): each
    subspace's argmax of ``x.c - |c|^2 / 2`` in fp32 (the first of equal
    maxima). 8-bit codebooks give centered codes [M, n] int8 (id - 128),
    4-bit ones nibble-packed codes [M/2, n]. Rows go through in chunks that
    keep the [M, rows, k] scores near 512 MB."""
    reps = torch.as_tensor(reps)
    n, H = reps.shape
    M, k, d = codebooks.shape
    cb = codebooks.to(device=reps.device, dtype=torch.float32)
    _check_fp32(cb, "pq_encode_device")
    half = 0.5 * (cb * cb).sum(2)
    step = max(1, _ENCODE_CHUNK // (M * k))
    out = []
    for s in range(0, n, step):
        x = reps[s:s + step].float().reshape(-1, M, d).permute(1, 0, 2)
        scores = torch.bmm(x, cb.transpose(1, 2))
        scores.sub_(half[:, None, :])
        out.append(torch.argmax(scores, dim=2))
        del scores
    assign = torch.cat(out, dim=1) if out else torch.zeros((M, 0), dtype=torch.int64,
                                                             device=reps.device)
    if k <= 16:
        return (assign[0::2] | (assign[1::2] << 4)).to(torch.int8)  # 128..255 wrap
    return (assign - 128).to(torch.int8)


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstructions [n, H] fp32 of codes (centered [M, n] for 8-bit
    codebooks, nibble-packed [M/2, n] for 4-bit; pq.py:173-187)."""
    M, k, d = codebooks.shape
    idx = _code_ids(codes, k)
    cb = codebooks.to(device=codes.device, dtype=torch.float32)
    dec = cb[torch.arange(M, device=codes.device)[:, None], idx]  # [M, n, d]
    return dec.permute(1, 0, 2).reshape(codes.shape[1], M * d)


def pq_blockwise_topk(q_reps: torch.Tensor, codes: torch.Tensor, codebooks: torch.Tensor, k: int,
                      block_size: int = 1024, valid: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-ADC top-k (pq.py:195-250): true-fp32 scores of q_reps [Q, H]
    against the reconstruction of every stored row (codes [M_storage, N]),
    a running top-k merged block by block; rows >= ``valid`` masked, ties to
    the smaller id. Returns (scores [Q, k], ids [Q, k] int32)."""
    N = codes.shape[1]
    n_valid = N if valid is None else int(valid)
    dev = codes.device
    qf = q_reps.to(device=dev, dtype=torch.float32)
    _check_fp32(qf, "pq_blockwise_topk")
    Q = qf.shape[0]
    run_s = torch.full((Q, k), float("-inf"), dtype=torch.float32, device=dev)
    run_i = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    for start in range(0, N, block_size):
        dec = pq_decode(codes[:, start:start + block_size], codebooks)
        s = torch.matmul(qf, dec.T)
        ids = torch.arange(start, start + dec.shape[0], dtype=torch.int32, device=dev)
        s = torch.where(ids[None, :] < n_valid, s, float("-inf"))
        sv, pos = torch.sort(torch.cat([run_s, s], 1), dim=1, descending=True, stable=True)
        run_s = sv[:, :k].contiguous()
        run_i = torch.gather(torch.cat([run_i, ids.expand(Q, -1)], 1), 1, pos[:, :k])
    return run_s, run_i


# -- the serve kernels' operands ------------------------------------------------------------------


def build_bdcb(codebooks: np.ndarray) -> torch.Tensor:
    """The block-diagonal decode operand [H / 128, 128, G * k] bf16 (on the
    host) of codebooks [M, k, d] (pq.py:258-274): row ``ml * d + dd``,
    column ``ml * k + c`` of group g holds ``codebooks[g * G + ml, c, dd]``."""
    codebooks = np.asarray(codebooks, np.float32)
    M, k, d = codebooks.shape
    if 128 % d:
        raise ValueError(f"d_sub={d} must divide 128 for the decode layout")
    G = 128 // d
    if M % G:
        raise ValueError(f"M={M} must be a multiple of {G} subspaces per 128-dim group")
    bdcb = np.zeros((M // G, 128, G * k), np.float32)
    for g in range(M // G):
        for ml in range(G):
            bdcb[g, ml * d:(ml + 1) * d, ml * k:(ml + 1) * k] = codebooks[g * G + ml].T
    return torch.from_numpy(bdcb).to(torch.bfloat16)


def build_bdcb_i8(codebooks: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 decode operand (pq.py:277-290): (bdcb int8 [H / 128, 128,
    G * k], scale [H / 128, 128, 1] fp32), symmetric scales per output dim
    (amax / 127 of the bf16-rounded entries, 1 for an all-zero dim), entries
    rounded half to even and clipped to +-127, in numpy."""
    bd = build_bdcb(codebooks).float().numpy()
    amax = np.max(np.abs(bd), axis=2)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(bd / scale[:, :, None]), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(scale[:, :, None])


def bdcb_table(bdcb: torch.Tensor, scale: Optional[torch.Tensor] = None, k: int = K
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The compact table the kernels read, cut out of a block-diagonal
    operand: (table [M, k, d_sub] of bdcb's dtype, per-dim scale [H] fp32 or
    None). ``table[m, c, dd]`` is the entry at row ``ml * d + dd``, column
    ``ml * k + c`` of group ``m // G``, so the kernels decode exactly the
    values the one-hot matmul picks."""
    n_groups, rows, GK = bdcb.shape
    G = GK // k
    d = rows // G
    blocks = bdcb.reshape(n_groups, G, d, G, k)
    diag = torch.diagonal(blocks, dim1=1, dim2=3)           # [g, d, k, G]
    table = diag.permute(0, 3, 2, 1).reshape(n_groups * G, k, d).contiguous()
    return table, None if scale is None else scale.reshape(-1).float().contiguous()


def _decoded_table(table: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The bf16 values the kernels stage: the bf16 table, or bf16(float(int8
    entry) x scale[dim]) rounded once."""
    if scale is None:
        return table.to(torch.bfloat16)
    M, k, d = table.shape
    return (table.float() * scale.reshape(M, 1, d)).to(torch.bfloat16)


def pq_chunk_rows(N: int, block_size: int) -> int:
    """Rows of one chunk of the serve kernels over N rows in blocks of
    ``block_size``: a whole number of blocks, about PQ_CHUNK_ROWS rows but at
    least one block, no more blocks than the corpus has nor than a grid's
    65535. The scratch holds min(chunk, N) decoded rows, so its bytes do not
    grow with N."""
    per = max(1, min(-(-N // block_size), PQ_CHUNK_ROWS // block_size, 65535))
    return per * block_size


def _pq_decode_reference(codes, table, scale, nbits: int, row0: int, rows: int) -> torch.Tensor:
    """Plain version of the decode pass: code columns row0 .. row0 + rows - 1
    decoded to bf16 rows [rows, H] through the table (K16: bf16(float(entry)
    x scale[dim]), rounded once)."""
    M, k, d = table.shape
    tab = _decoded_table(table, scale)
    idx = _code_ids(codes[:, row0:row0 + rows], 1 << nbits)
    return tab[torch.arange(M, device=codes.device)[:, None], idx].permute(1, 0, 2).reshape(
        rows, M * d)


def _pq_topj_reference(q, codes, table, J: int, block_size: int, n_valid: int, scale=None,
                       nbits: int = 8, chunk_rows: Optional[int] = None):
    """Plain version of K15 (and, with ``scale``, K16), chunk by chunk under
    the kernels' plan (``chunk_rows``, default :func:`pq_chunk_rows`): each
    chunk's rows decoded to bf16, bf16(q) scored against them with fp32 sums,
    rows >= n_valid masked, the serve selection per block (ties to the
    smaller id). Returns (vals [Q, n_blocks, J], ids)."""
    Q, N = q.shape[0], codes.shape[1]
    chunk = pq_chunk_rows(N, block_size) if chunk_rows is None else chunk_rows
    if chunk % block_size:
        raise ValueError(f"a chunk of {chunk} rows is no whole number of {block_size}-row blocks")
    qb = q.to(torch.bfloat16).float()
    n_blocks = -(-N // block_size)
    vals = torch.full((Q, n_blocks, J), float("-inf"), dtype=torch.float32, device=q.device)
    ids = torch.full((Q, n_blocks, J), -1, dtype=torch.int32, device=q.device)
    for row0 in range(0, N, chunk):
        rows = min(chunk, N - row0)
        dec = _pq_decode_reference(codes, table, scale, nbits, row0, rows).float()
        v, i = _per_block(lambda a, b: torch.matmul(qb, dec[a:b].T), _select_packed, Q, rows, J,
                          block_size, n_valid - row0, q.device)
        b0 = row0 // block_size
        vals[:, b0:b0 + v.shape[1]] = v
        ids[:, b0:b0 + v.shape[1]] = torch.where(i >= 0, i + row0, -1)
    return vals, ids


def _check_table(name, H, codes, table, scale, nbits, device):
    """The operands' shapes and devices: table [M, k, d] with M * d = H, the
    codes' storage rows, the scale [H] of an int8 table."""
    if table.ndim != 3:
        raise ValueError(f"{name}: table must be [M, k, d_sub], got {tuple(table.shape)}")
    M, k, d = table.shape
    if nbits not in (4, 8) or k != (16 if nbits == 4 else 256) or M * d != H:
        raise ValueError(f"{name}: a {nbits}-bit table of dim {H} is [M, "
                         f"{16 if nbits == 4 else 256}, H / M], got {tuple(table.shape)}")
    if H % 128 or 128 % d:
        raise ValueError(f"{name}: the decode kernels take d_sub | 128 and 128 | H, got d_sub="
                         f"{d}, H={H}")
    if codes.dtype != torch.int8 or codes.ndim != 2 or \
            codes.shape[0] != (M // 2 if nbits == 4 else M):
        raise ValueError(f"{name}: codes must be int8 [{M // 2 if nbits == 4 else M}, N], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if (scale is None) != (table.dtype == torch.bfloat16):
        raise TypeError(f"{name}: a bf16 table takes no scale, an int8 table its per-dim scale; "
                        f"got {table.dtype}, scale {scale is not None}")
    if table.dtype not in (torch.bfloat16, torch.int8) or (scale is not None and (
            nbits == 4 or scale.dtype != torch.float32 or scale.shape != (H,))):
        raise ValueError(f"{name}: the int8 table is an 8-bit option with a float32 [{H}] scale")
    for t in (codes, table, scale):
        if t is not None and t.device != device:
            raise ValueError(f"{name}: every operand must be on {device}")


def pq_topj_blocks(q: torch.Tensor, codes: torch.Tensor, table: torch.Tensor, J: int,
                   block_size: int, n_valid: int, scale: Optional[torch.Tensor] = None,
                   nbits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block top-J over PQ codes (K15; K16 with ``scale``): q [Q, H]
    (bf16 on CUDA), codes [M, N] (8-bit) or [M/2, N] (4-bit), table [M, k,
    d_sub] bf16 (int8 with ``scale`` [H], 8-bit only), rows >= n_valid
    masked. Returns (vals [Q, n_blocks, J] fp32, ids int32), n_blocks =
    ceil(N / block_size); an empty slot is (-inf, -1). On CUDA the corpus
    goes through in chunks of :func:`pq_chunk_rows` rows, decoded into one
    bf16 scratch [min(chunk, N), H] (48 MB at H = 768), then scored."""
    H = q.shape[1]
    if not codes.is_cuda:
        return _pq_topj_reference(q, codes, table, J, block_size, n_valid, scale, nbits)
    name = "pq_topj_blocks"
    _check_table(name, H, codes, table, scale, nbits, q.device)
    if q.dtype != torch.bfloat16 or q.ndim != 2 or q.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels take 16-byte aligned bf16 queries [Q, H], got "
                         f"{q.dtype} {tuple(q.shape)}")
    if not (1 <= J <= min(JMAX, block_size)):
        raise ValueError(f"{name}: the kernel keeps 1 <= J <= {JMAX} per block, got {J}")
    Q, N = q.shape[0], codes.shape[1]
    n_blocks = -(-N // block_size)
    vals = torch.empty((Q, n_blocks, J), dtype=torch.float32, device=q.device)
    ids = torch.empty((Q, n_blocks, J), dtype=torch.int32, device=q.device)
    if Q == 0 or N == 0:
        return vals, ids
    q, codes, table = q.contiguous(), codes.contiguous(), table.contiguous()
    chunk = pq_chunk_rows(N, block_size)
    scratch = torch.empty((min(chunk, N), H), dtype=torch.bfloat16, device=q.device)
    counter = "launches_4bit" if nbits == 4 else ("launches_i8dec" if scale is not None
                                                  else "launches")
    lib = _native.library()
    launched = (ctypes.c_int * 2)()  # the C loop's decode and scoring launches
    err = lib.drt_pq_topj(
        q.data_ptr(), codes.data_ptr(), table.data_ptr(),
        0 if scale is None else scale.data_ptr(), scratch.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), Q, N, H, table.shape[2], nbits, int(n_valid), int(block_size), int(J),
        chunk, ctypes.addressof(launched), _native.stream_ptr(q))
    pq_topj_blocks.launches_decode += launched[0]
    setattr(pq_topj_blocks, counter, getattr(pq_topj_blocks, counter) + launched[1])
    _native.check(err, "drt_pq_topj")
    return vals, ids


# launches made, as the C loop counts them: one of each kernel a chunk
pq_topj_blocks.launches = 0         # K15's scoring body, 8-bit codes
pq_topj_blocks.launches_4bit = 0    # K15's scoring body, 4-bit codes
pq_topj_blocks.launches_i8dec = 0   # K16's scoring body
pq_topj_blocks.launches_decode = 0  # the decode pass (K15 and K16)


def pq_serve_topk(q_reps: torch.Tensor, codes: torch.Tensor, codebooks: torch.Tensor,
                  table: torch.Tensor, k: int, block_size: int = PQ_BLOCK,
                  valid: Optional[int] = None, nbits: int = 8,
                  scale: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The PQ serve search (``pallas_topk_pq_fast``, pq.py:553-588): the
    Poisson J of the reference (:573-575) with the block halved while it
    exceeds the kernels' 32 slots (``serve_plan``), K15 / K16 candidates and
    their merge. A tiny corpus (the reference's rule, :576) takes the exact
    ADC scan instead, counted in ``pq_serve_topk.exact_scans``. Returns
    (scores [Q, k'], ids [Q, k']), k' = min(k, valid rows)."""
    N = codes.shape[1]
    n_valid = int(N if valid is None else valid)
    q32 = q_reps.to(device=codes.device, dtype=torch.float32)
    plan = serve_plan(k, N, n_valid, block_size)
    if plan is None:
        pq_serve_topk.exact_scans += 1
        return pq_blockwise_topk(q32, codes, codebooks, min(k, n_valid),
                                 max(1, min(block_size, N)), valid=n_valid)
    block, J = plan
    vals, ids = pq_topj_blocks(q32.to(torch.bfloat16), codes, table, J, block, n_valid, scale,
                               nbits)
    return _top(vals, ids, min(k, n_valid))


pq_serve_topk.exact_scans = 0

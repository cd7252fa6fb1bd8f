"""Cell-major bulk IVF-PQ search: probe, invert, the PQ cell kernel K17, merge.

Counterpart of ``denseretrievaltoolkits_tpu/ops/ivf_pq.py``: the ragged bulk
IVF search of ``ops/ivf_bulk.py`` over cells that store PQ codes of
residuals (``x - centroid``), step for step:

1. **probe**: one [B, nlist] centroid product in fp32; the raw scores are
   kept, since a pair's score ``q . centroid`` is its residual offset;
2. **invert**: :func:`..ivf_bulk.invert_probe_pairs`, and each (cell, slot)
   gets its pair's raw probe score (``poff``, ivf_pq.py:209-213);
3. **score**: :func:`ragged_topj_pq` (K17) walks the ragged block list:
   each block's codes decode to bf16 rows through the table (``ops/pq.py``),
   score against the cell's bf16 query slab with fp32 sums, get their slot's
   ``poff`` added, rows with ``row_id < 0`` are masked, and each selection
   block keeps its J best with the serve selection; the slots past each
   cell's filled count (``filled_slots``, computed on the device) get (-inf,
   -1). It is the PQ row type of K14's wgmma + TMA body in
   ``csrc/ivf_cell.cu`` (``drt_ivf_pq_cell``): filled slots and stored-row
   tiles only, the codes decoded to bf16 inside the body; the selection block
   halves inside a storage block while the Poisson J exceeds the lists' 32
   (``selection_plan``). Plain version :func:`_ivf_pq_topj_reference`; CPU
   tensors take it, CUDA tensors launch the kernel or raise; launches in
   ``ragged_topj_pq.launches``;
4. **merge**: the ragged merges of ``ops/ivf_bulk.py``, then the dense side
   scan of hot cells (their rows decoded once to reconstructions and
   quantized by K7, scored by K8) and the -1 sentinel.

The TPU's packed selection rounds scores to about 2^id_bits ulps; here they
come back exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _native
from .ivf_bulk import (_PLAIN_CHUNK, ProbeSlab, _clear_empty_slots, _descending, _finish,
                       _packed_topj, filled_slots, invert_probe_pairs, ragged_merge)
from .pq import _check_table, _code_ids
from .topk import JMAX


def _ivf_pq_topj_reference(qslab, codes, row_ids, poff, table, block_cell, J: int, block: int,
                           sel: int, nbits: int = 8, slots=None):
    """Plain version of K17 over codes [M_storage, N] in N / block storage
    blocks (cell ``block_cell[b]``), each cut into selection blocks of
    ``sel`` rows: bf16 decode, fp32 scores + the slot offset, row-id mask,
    serve selection. Returns (vals, ids) [n_sel, Qcap, J]; with ``slots``
    [nlist], the lists of a cell's slots at or past its entry are (-inf,
    -1)."""
    nlist, Qcap, H = qslab.shape
    M, k, d = table.shape
    N = codes.shape[1]
    n_blocks, per = N // block, -(-block // sel)
    dev = codes.device
    tab = table.to(torch.bfloat16).float()
    m_idx = torch.arange(M, device=dev)[:, None]
    out_v = torch.empty((n_blocks * per, Qcap, J), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_blocks * per, Qcap, J), dtype=torch.int32, device=dev)
    step = max(1, min(_PLAIN_CHUNK // (Qcap * per * sel), _PLAIN_CHUNK // (block * H)))
    local = (torch.arange(per, device=dev)[:, None] * sel
             + torch.arange(sel, device=dev)[None, :])
    for b0 in range(0, n_blocks, step):
        b1 = min(n_blocks, b0 + step)
        b = torch.arange(b0, b1, device=dev)
        cells = block_cell[b0:b1].long()
        idx = _code_ids(codes[:, b0 * block:b1 * block], k)
        rows = tab[m_idx, idx].permute(1, 0, 2).reshape(b1 - b0, block, H)
        s = torch.bmm(qslab[cells].float(), rows.transpose(1, 2)) + poff[cells][:, :, None]
        rid = row_ids[b0 * block:b1 * block].reshape(b1 - b0, 1, block)
        s = torch.where(rid >= 0, s, float("-inf"))
        s = torch.nn.functional.pad(s, (0, per * sel - block), value=float("-inf"))
        ids = (b * block)[:, None, None, None] + local[None, None]
        v, i = _packed_topj(s.reshape(b1 - b0, Qcap, per, sel), ids, J)
        out_v[b0 * per:b1 * per] = v.permute(0, 2, 1, 3).reshape(-1, Qcap, J)
        out_i[b0 * per:b1 * per] = i.permute(0, 2, 1, 3).reshape(-1, Qcap, J)
    if slots is not None:
        _clear_empty_slots(out_v, out_i, slots, block_cell, 1, per)
    return out_v, out_i


def ragged_topj_pq(block_cell: torch.Tensor, qslab: torch.Tensor, codes: torch.Tensor,
                   row_ids: torch.Tensor, poff: torch.Tensor, table: torch.Tensor, J: int,
                   block: int, sel: Optional[int] = None, nbits: int = 8,
                   slots: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17 over the ragged padded-flat layout of PQ codes: qslab [nlist,
    Qcap, H] bf16 against codes [M, nb_total * block] (8-bit) or [M/2, ...]
    (4-bit) whose block b belongs to cell ``block_cell[b]`` (int32
    [nb_total]), table [M, k, d_sub] bf16, poff [nlist, Qcap] fp32 added to
    every score of its slot, row_ids [nb_total * block] int32 (-1 = padding,
    masked); ``slots`` int32 [nlist]: each cell's filled slots, its first
    ones (None: every slot), the others' lists (-inf, -1). Returns (vals,
    ids) [nb_total * ceil(block / sel), Qcap, J], ids flat positions."""
    sel = block if sel is None else sel
    if not codes.is_cuda:
        return _ivf_pq_topj_reference(qslab, codes, row_ids, poff, table, block_cell, J, block,
                                      sel, nbits, slots)
    name = "ragged_topj_pq"
    nlist, Qcap, H = qslab.shape
    _check_table(name, H, codes, table, None, nbits, qslab.device)
    N = codes.shape[1]
    if qslab.dtype != torch.bfloat16 or qslab.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a 16-byte aligned bf16 query slab, got "
                         f"{qslab.dtype}")
    if (N % block or row_ids.shape != (N,) or row_ids.dtype != torch.int32
            or block_cell.shape != (N // block,) or block_cell.dtype != torch.int32
            or poff.shape != (nlist, Qcap) or poff.dtype != torch.float32
            or not row_ids.device == block_cell.device == poff.device == qslab.device):
        raise ValueError(f"{name}: codes of {N} rows in {block}-row blocks take int32 row ids "
                         f"[{N}], int32 block cells [{N // max(1, block)}] and float32 offsets "
                         f"[{nlist}, {Qcap}] on {qslab.device}")
    if not (1 <= J <= JMAX and J <= sel <= block):
        raise ValueError(f"{name}: the kernel keeps 1 <= J <= {JMAX} <= selection block {sel} "
                         f"<= block {block}, got J={J}")
    if slots is not None and (slots.dtype != torch.int32 or slots.shape != (nlist,)
                              or slots.device != qslab.device):
        raise ValueError(f"{name}: slots must be int32 [{nlist}] on {qslab.device}")
    n_sel = N // block * -(-block // sel)
    vals = torch.empty((n_sel, Qcap, J), dtype=torch.float32, device=codes.device)
    ids = torch.empty((n_sel, Qcap, J), dtype=torch.int32, device=codes.device)
    if N == 0 or Qcap == 0:
        return vals, ids
    qslab, codes, table, poff = qslab.contiguous(), codes.contiguous(), table.contiguous(), \
        poff.contiguous()
    lib = _native.library()
    ragged_topj_pq.launches += 1
    _native.check(lib.drt_ivf_pq_cell(
        qslab.data_ptr(), codes.data_ptr(), table.data_ptr(), poff.data_ptr(),
        row_ids.data_ptr(), block_cell.data_ptr(), 0 if slots is None else slots.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), nlist, Qcap, N, H, table.shape[2], nbits, int(block),
        int(sel), int(J), _native.stream_ptr(codes)), "drt_ivf_pq_cell")
    return vals, ids


ragged_topj_pq.launches = 0


def pq_probe_slab(q: torch.Tensor, centroids: torch.Tensor, nlist: int, nprobe: int, Qcap: int,
                  hot_penalty: Optional[torch.Tensor] = None, n_real=None
                  ) -> Tuple[ProbeSlab, torch.Tensor]:
    """Steps 1-2 (ivf_pq.py:200-217): the probe of fp32 queries, the inverted
    slot table with its bf16 query slab, and the per-slot offsets poff [nlist,
    Qcap] (each slot's raw probe score; 0 for an empty slot)."""
    B, dim = q.shape
    raw = torch.matmul(q, centroids.T)
    cells = _descending(raw if hot_penalty is None else raw + hot_penalty[None, :], nprobe)
    qtab, dest, sc, slot, in_cap, order, counts, n_dropped = invert_probe_pairs(
        cells, B, nprobe, nlist, Qcap, B if n_real is None else n_real)
    ptab = torch.zeros(nlist * Qcap + 1, dtype=torch.float32, device=q.device)
    ptab[dest] = raw.gather(1, cells).reshape(-1)[order]
    qc = q.to(torch.bfloat16)
    qslab = qc[qtab].reshape(nlist, Qcap, dim)
    ps = ProbeSlab(qtab, sc, slot, in_cap, order, counts, n_dropped, qc, qslab, None, None, None)
    return ps, ptab[:-1].reshape(nlist, Qcap)


def ivf_pq_search(q, centroids, codes, row_ids, block_cell, block_start, table, side_values,
                  side_scales, side_ids, k: int, nprobe: int, Qcap: int, J: int, block: int,
                  sel: int, nlist: int, nb_max: int, hot_penalty=None, side_valid: int = 0,
                  side_J: int = 4, side_block: int = 512, nbits: int = 8, n_real=None):
    """The bulk IVF-PQ search (ivf_pq.py:182-253): q [B, dim] fp32; codes,
    row_ids, block_cell and block_start the ragged layout of
    :class:`..index.ivf_pq.IVFPQIndex`; table [M, k, d_sub] bf16; the kernel's
    plan (``block``, ``sel``, ``J``); the side slab of hot cells (int8
    reconstructions with scales, ``side_valid`` real rows) and
    ``hot_penalty``; ``n_real`` the real queries. Returns (scores [B, k],
    doc_rows [B, k] (-1: no row), n_dropped, probe_counts [nlist]) on the
    device, with no host sync."""
    ps, poff = pq_probe_slab(q, centroids, nlist, nprobe, Qcap, hot_penalty, n_real)
    vals_b, ids_b = ragged_topj_pq(block_cell, ps.qslab, codes, row_ids, poff, table, J, block,
                                   sel, nbits, filled_slots(ps, Qcap))
    tv, ti = ragged_merge(vals_b, ids_b, ps, block_start, block, sel, nb_max, nprobe, k)
    tv, doc = _finish(tv, ti, row_ids, ps, (side_values, side_scales, side_ids, side_valid,
                                            side_J, side_block), k)
    return tv, doc, ps.n_dropped, ps.counts

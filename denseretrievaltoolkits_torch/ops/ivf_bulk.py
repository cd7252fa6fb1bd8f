"""Cell-major bulk IVF search: probe, invert, the cell kernels K13 and K14, merge.

Counterpart of ``denseretrievaltoolkits_tpu/ops/ivf_bulk.py``, the same
algorithm step for step, so results, drops and probe counts can be held to
the JAX package:

1. **probe**: one [B, nlist] centroid product; the top-``nprobe`` cells of
   each query (a stable descending sort: ties to the lower cell, as
   ``lax.top_k``);
2. **invert** (:func:`invert_probe_pairs`): the (query, cell) pairs, sorted
   by (cell, probe rank), fill a fixed-capacity table of ``Qcap`` query
   slots per cell; pairs beyond it are counted and dropped;
3. **score**: the cell kernel gathers nothing: a block of one cell's rows is
   scored against the cell's slab of probing queries [Qcap, dim], then the
   serve selection keeps each slot's best J rows of the block. K13
   (:func:`cell_topj`) walks the fixed-capacity layout [nlist, C, dim], K14
   (:func:`ragged_topj`) the ragged padded-flat block list, whose
   ``block_cell`` map names each block's cell. Both are one C entry,
   ``drt_ivf_cell`` in ``csrc/ivf_cell.cu``: the searches pass ``slots``,
   each cell's filled query slots (:func:`filled_slots`), and the kernel
   scores and selects only those, and only row tiles holding a stored row;
   the other slots' lists come back (-inf, -1). Bodies: fp32 and bf16
   cells (queries of the cells' dtype), int8 cells x per-row scales (bf16
   queries) and i8q (int8 queries, s32 products, x row scale x slot
   scale). Launches are counted per body in ``<wrapper>.launches`` (fp32 /
   bf16 cells), ``.launches_int8`` and ``.launches_i8q``. Shapes the new
   bodies do not take (``drt_ivf_cell_takes``: bf16 / int8 rows at
   H % 64 != 0, i8q at H % 128 != 0, unaligned operands) run the block
   top-J family's body, ``drt_ivf_topj`` in ``csrc/block_topj.cu``, whose
   launches also count on ``.launches_generic``. CPU tensors take the plain
   version of both, :func:`_ivf_topj_reference`; CUDA tensors launch a
   kernel or raise;
4. **merge**: per (cell, slot) over the cell's blocks, per pair back to
   query order, per query; then the dense side scan (overflow rows and hot
   cells) on K8 (:func:`..topk.block_topj_serve`) or K12
   (:func:`..topk.block_topj_i8q`), and the -1 sentinel for result slots
   with no finite candidate.

Two things differ from the TPU's kernels, by design. Their packed selection
rounds scores to about 2^id_bits ulps; here the (score, id) key has 64 bits
and scores come back exact. And the kernels keep J <= 32 per list, where the
reference's Poisson J (:func:`serve_j`) reaches k: :func:`selection_plan`
then halves the selection block (inside one storage block, so inside one
cell) until the J of that width fits, as ``ops/topk.py:serve_plan`` does for
the flat serve search. Empty slots and masked rows come back as (-inf, -1)
where the TPU writes -1e30 and a row position; both end as the -1 sentinel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _native
from .quant import quantize_queries
from .topk import JMAX, TYPE_CODES, block_topj_i8q, block_topj_serve

# a result slot scoring below NEG_INF / 2 holds no row (the reference's -1e30 mask)
NEG_INF = -1e30
# elements of one [blocks, Qcap, block] score chunk in the plain versions
_PLAIN_CHUNK = 1 << 25


def serve_j(k: int, block: int, C: int) -> int:
    """Per-block candidate slots (ivf_bulk.py:325-335): a query's top-k rows
    inside one probed cell spread over the cell's blocks, ~Poisson(k * block
    / C) per block; mean + 4 sqrt + 4 bounds the overflow at ~1e-6, at least
    enough that one cell can hold all k, at most min(k, block)."""
    nb = max(1, C // block)
    lam = k * block / max(block, C)
    J = int(np.ceil(lam + 4.0 * np.sqrt(lam) + 4.0))
    J = max(J, -(-k // nb))
    return min(J, k, block)


def selection_plan(k: int, block: int, C: int, J: int) -> Tuple[int, int]:
    """(rows per selection block, J) for the cell kernels: ``(block, J)``
    while J fits the kernels' ``JMAX`` lists, else the selection block
    halves (rounding up) and J is the :func:`serve_j` of that width over
    cells of C rows, until it fits; it always ends, since J <= the width."""
    sel = block
    while J > JMAX:
        sel = -(-sel // 2)
        J = serve_j(k, sel, C)
    return sel, J


def invert_probe_pairs(cells: torch.Tensor, B: int, nprobe: int, nlist: int, Qcap: int,
                       n_real) -> Tuple[torch.Tensor, ...]:
    """The (query, cell) probe pairs of ``cells`` [B, nprobe] as each cell's
    table of ``Qcap`` query slots (ivf_bulk.py:283-322).

    Rank-major slotting: a cell's slots go first to the pairs for which it is
    the top-ranked probe, so capacity drops land on low-ranked probes. Pairs
    of padding queries (rows >= ``n_real``) sort after every real rank and
    always drop, without being counted. Returns ``(qtab [nlist * Qcap],
    dest [P], sc [P], slot [P], in_cap [P] bool, order [P], counts [nlist],
    n_dropped)``, pair arrays in (cell, rank) order, ``order`` the original
    pair index of each; integers as int64 tensors on ``cells``' device, with
    no host sync."""
    dev = cells.device
    P = B * nprobe
    pair_cell = cells.reshape(-1).long()
    pair_q = torch.arange(B, device=dev).repeat_interleave(nprobe)
    pair_rank = torch.arange(nprobe, device=dev).repeat(B)
    real = pair_q < n_real
    rank_key = torch.where(real, pair_rank, nprobe)
    counts_all = torch.zeros(nlist, dtype=torch.int64, device=dev).index_add_(
        0, pair_cell, torch.ones_like(pair_cell))
    starts = torch.cumsum(counts_all, 0) - counts_all
    order = torch.argsort(pair_cell * (nprobe + 1) + rank_key, stable=True)
    sc = pair_cell[order]
    slot = torch.arange(P, device=dev) - starts[sc]
    real_s = real[order]
    in_cap = (slot < Qcap) & real_s
    counts = torch.zeros(nlist, dtype=torch.int64, device=dev).index_add_(
        0, pair_cell, real.long())
    n_dropped = (real_s & ~in_cap).sum()
    # out-of-capacity pairs go to one extra slot past the table, cut off after
    dest = torch.where(in_cap, sc * Qcap + slot, nlist * Qcap)
    qtab = torch.zeros(nlist * Qcap + 1, dtype=torch.int64, device=dev)
    qtab[dest] = pair_q[order]
    return qtab[:-1], dest, sc, slot, in_cap, order, counts, n_dropped


class ProbeSlab(NamedTuple):
    """Steps 1-3 of a bulk search up to the cell kernel."""
    qtab: torch.Tensor          # [nlist * Qcap] query of each slot (0 where empty)
    sc: torch.Tensor            # [P] cell of each pair, (cell, rank) order
    slot: torch.Tensor          # [P] slot of each pair in its cell
    in_cap: torch.Tensor        # [P] the pair got a slot
    order: torch.Tensor         # [P] original pair index
    counts: torch.Tensor        # [nlist] real probe pairs per cell
    n_dropped: torch.Tensor     # real pairs beyond Qcap (device scalar)
    qc: torch.Tensor            # [B, dim] queries in the cells' float type
    qslab: torch.Tensor         # [nlist, Qcap, dim] the kernel's query operand
    qscales: Optional[torch.Tensor]  # [nlist, Qcap] slot scales (i8q)
    qi: Optional[torch.Tensor]  # [B, dim] int8 queries (i8q)
    qs: Optional[torch.Tensor]  # [B] their scales (i8q)


def _descending(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest entries of each row, ties to the lower
    position, as ``lax.top_k``: a stable descending sort."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def _top(v: torch.Tensor, i: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, ids) of the k best candidates of each row of v [R, n]."""
    pos = _descending(v, k)
    return v.gather(1, pos), i.gather(1, pos)


def probe_slab(q: torch.Tensor, centroids: torch.Tensor, cell_dtype: torch.dtype, nlist: int,
               nprobe: int, Qcap: int, hot_penalty: Optional[torch.Tensor] = None,
               n_real=None, i8_native: bool = False) -> ProbeSlab:
    """Probe, invert and gather the query slab, as both bulk searches do
    (ivf_bulk.py:379-408, 510-534). fp32 cells score fp32 queries, bf16 and
    int8 cells bf16 ones; ``i8_native`` quantizes the queries with K7 and
    gathers int8 slots and their scales."""
    B, dim = q.shape
    cell_scores = torch.matmul(q, centroids.T)
    if hot_penalty is not None:
        cell_scores = cell_scores + hot_penalty[None, :]
    cells = _descending(cell_scores, nprobe)
    qtab, _, sc, slot, in_cap, order, counts, n_dropped = invert_probe_pairs(
        cells, B, nprobe, nlist, Qcap, B if n_real is None else n_real)
    qc = q.to(torch.float32 if cell_dtype == torch.float32 else torch.bfloat16)
    qi = qs = qscales = None
    if i8_native:
        qi, qs = quantize_queries(q)
        qslab = qi[qtab].reshape(nlist, Qcap, dim)
        qscales = qs[qtab].reshape(nlist, Qcap)
    else:
        qslab = qc[qtab].reshape(nlist, Qcap, dim)
    return ProbeSlab(qtab, sc, slot, in_cap, order, counts, n_dropped, qc, qslab, qscales, qi, qs)


# -- the cell kernels and their plain versions ---------------------------------------------------


def _packed_topj(s: torch.Tensor, rows: torch.Tensor, J: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serve selection over the last dim, as the kernels: one top-J on
    64-bit keys (order-preserving score bits high, inverted row id low), so
    ties go to the smaller id; (-inf, -1) for masked rows and empty slots."""
    rows = rows.expand_as(s)
    bits = s.contiguous().view(torch.int32).long()
    key = (torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF) << 32) | (0xFFFFFFFF - rows)
    key = torch.where(s == float("-inf"), torch.iinfo(torch.int64).min, key)
    pos = torch.topk(key, J, dim=-1).indices
    v = s.gather(-1, pos)
    return v, torch.where(v == float("-inf"), -1, rows.gather(-1, pos)).to(torch.int32)


def _cell_scores(qs, rows, scales, qscales) -> torch.Tensor:
    """fp32 scores [b, Qcap, block] of slabs qs [b, Qcap, H] against rows
    [b, block, H] under the kernels' formulas: fp32 in true fp32, bf16 exact
    products with fp32 sums, int8 rows (bf16 queries) x the row scale; i8q s32
    products (exact in fp32 while H * 127^2 < 2^24, else in fp64) x row scale
    x slot scale."""
    if qscales is not None:
        wide = torch.float32 if qs.shape[-1] * 127 * 127 < 2 ** 24 else torch.float64
        s32 = torch.bmm(qs.to(wide), rows.to(wide).transpose(1, 2)).float()
        return s32 * scales[:, None, :] * qscales[:, :, None]
    s = torch.bmm(qs.float(), rows.float().transpose(1, 2))
    return s if scales is None else s * scales[:, None, :]


def filled_slots(ps: ProbeSlab, Qcap: int) -> torch.Tensor:
    """int32 [nlist]: each cell's filled query slots, its first
    ``min(counts, Qcap)`` (:func:`invert_probe_pairs` gives a cell's real
    pairs its first slots); the cell kernels' ``slots``."""
    return ps.counts.clamp(max=Qcap).to(torch.int32)


def _clear_empty_slots(vals, ids, slots, block_cell, cell_blocks, per: int) -> None:
    """(-inf, -1) in place in the lists [n_sel, Qcap, J] of every slot at or
    past its cell's ``slots`` entry (selection block i in storage block
    i // per, whose cell is ``block_cell`` or the block // ``cell_blocks``)."""
    n_sel, Qcap = vals.shape[:2]
    blocks = torch.arange(n_sel, device=vals.device) // per
    cells = blocks // cell_blocks if block_cell is None else block_cell.long()[blocks]
    empty = (torch.arange(Qcap, device=vals.device)[None, :]
             >= slots.long()[cells][:, None])[:, :, None]
    vals.masked_fill_(empty, float("-inf"))
    ids.masked_fill_(empty, -1)


def _ivf_topj_reference(qslab, values, row_ids, scales, qscales, block_cell, cell_blocks,
                        J: int, block: int, sel: int, slots=None):
    """Plain version of the IVF cell kernels over values [N, H] in N / block
    storage blocks (cell ``block_cell[b]``, or ``b // cell_blocks``), each cut
    into selection blocks of ``sel`` rows: (vals, ids) [n_sel, Qcap, J]; with
    ``slots`` [nlist], the lists of a cell's slots at or past its entry are
    (-inf, -1)."""
    N, H = values.shape
    Qcap = qslab.shape[1]
    n_blocks, per = N // block, -(-block // sel)
    dev = values.device
    out_v = torch.empty((n_blocks * per, Qcap, J), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_blocks * per, Qcap, J), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_CHUNK // (Qcap * per * sel))
    local = (torch.arange(per, device=dev)[:, None] * sel
             + torch.arange(sel, device=dev)[None, :])          # [per, sel] row in block
    for b0 in range(0, n_blocks, step):
        b1 = min(n_blocks, b0 + step)
        b = torch.arange(b0, b1, device=dev)
        cells = b // cell_blocks if block_cell is None else block_cell[b0:b1].long()
        rows = values[b0 * block:b1 * block].reshape(b1 - b0, block, H)
        sl = None if scales is None else scales[b0 * block:b1 * block].reshape(b1 - b0, block)
        s = _cell_scores(qslab[cells], rows, sl, None if qscales is None else qscales[cells])
        rid = row_ids[b0 * block:b1 * block].reshape(b1 - b0, 1, block)
        s = torch.where(rid >= 0, s, float("-inf"))
        s = torch.nn.functional.pad(s, (0, per * sel - block), value=float("-inf"))
        ids = (b * block)[:, None, None, None] + local[None, None]  # [b, 1, per, sel]
        v, i = _packed_topj(s.reshape(b1 - b0, Qcap, per, sel), ids, J)
        out_v[b0 * per:b1 * per] = v.permute(0, 2, 1, 3).reshape(-1, Qcap, J)
        out_i[b0 * per:b1 * per] = i.permute(0, 2, 1, 3).reshape(-1, Qcap, J)
    if slots is not None:
        _clear_empty_slots(out_v, out_i, slots, block_cell, cell_blocks, per)
    return out_v, out_i


def _launch(wrapper, qslab, values, row_ids, scales, qscales, block_cell, cell_blocks, J, block,
            sel, slots=None):
    """Check the operands and launch ``drt_ivf_cell``, or ``drt_ivf_topj`` for
    a shape it does not take; one launch adds one to the counter of its body
    on ``wrapper`` (and, on ``drt_ivf_topj``, to ``launches_generic``)."""
    name = wrapper.__name__
    nlist, Qcap, H = qslab.shape
    N = values.shape[0]
    int8_rows = values.dtype == torch.int8
    if qscales is not None:
        counter, want_q = "launches_i8q", torch.int8
    else:
        counter = "launches_int8" if int8_rows else "launches"
        want_q = torch.bfloat16 if int8_rows else values.dtype
    if (values.dtype not in TYPE_CODES or qslab.dtype != want_q
            or int8_rows != (scales is not None) or (qscales is not None and not int8_rows)):
        raise TypeError(f"{name}: {values.dtype} cells take {want_q} query slots"
                        f"{' and per-row scales' if int8_rows else ''}; got {qslab.dtype}, "
                        f"scales {scales is not None}")
    if (values.ndim != 2 or values.shape[1] != H or N % block or row_ids.shape != (N,)
            or row_ids.dtype != torch.int32 or not values.device == qslab.device == row_ids.device):
        raise ValueError(f"{name}: values {tuple(values.shape)} in {block}-row blocks, row ids "
                         f"{tuple(row_ids.shape)} {row_ids.dtype}, slab {tuple(qslab.shape)}: "
                         f"shapes or devices do not match")
    for what, t, shape in (("scales", scales, (N,)), ("slot scales", qscales, (nlist, Qcap))):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape
                              or t.device != values.device):
            raise ValueError(f"{name}: {what} must be float32 {list(shape)}")
    if slots is not None and (slots.dtype != torch.int32 or slots.shape != (nlist,)
                              or slots.device != values.device):
        raise ValueError(f"{name}: slots must be int32 [{nlist}]")
    if not (1 <= J <= JMAX and J <= sel <= block):
        raise ValueError(f"{name}: the kernel keeps 1 <= J <= {JMAX} <= selection block "
                         f"{sel} <= block {block}, got J={J}")
    if qscales is not None and (H % 64 or qslab.data_ptr() % 16 or values.data_ptr() % 16):
        raise ValueError(f"{name}: the s8 tensor-core body takes H % 64 == 0 and 16-byte "
                         f"aligned rows, got H={H}")
    n_sel = N // block * -(-block // sel)
    vals = torch.empty((n_sel, Qcap, J), dtype=torch.float32, device=values.device)
    ids = torch.empty((n_sel, Qcap, J), dtype=torch.int32, device=values.device)
    if N == 0 or Qcap == 0:
        return vals, ids
    qslab, values = qslab.contiguous(), values.contiguous()
    lib = _native.library()
    qtype, ctype = TYPE_CODES[qslab.dtype], TYPE_CODES[values.dtype]
    ptrs = (qslab.data_ptr(), values.data_ptr(), 0 if scales is None else scales.data_ptr(),
            0 if qscales is None else qscales.contiguous().data_ptr(), row_ids.data_ptr(),
            0 if block_cell is None else block_cell.data_ptr())
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    if lib.drt_ivf_cell_takes(qslab.data_ptr(), values.data_ptr(), H, qtype, ctype):
        _native.check(lib.drt_ivf_cell(
            *ptrs, 0 if slots is None else slots.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            nlist, Qcap, N, H, int(block), int(sel), int(J), int(cell_blocks), qtype, ctype,
            _native.stream_ptr(values)), "drt_ivf_cell")
        return vals, ids
    wrapper.launches_generic += 1
    _native.check(lib.drt_ivf_topj(
        *ptrs, vals.data_ptr(), ids.data_ptr(), Qcap, N, H, int(block), int(sel), int(J),
        int(cell_blocks), qtype, ctype, _native.stream_ptr(values)), "drt_ivf_topj")
    if slots is not None:
        _clear_empty_slots(vals, ids, slots, block_cell, cell_blocks, -(-block // sel))
    return vals, ids


def cell_topj(qslab: torch.Tensor, values: torch.Tensor, row_ids: torch.Tensor,
              scales: Optional[torch.Tensor], J: int, block: int, sel: Optional[int] = None,
              qscales: Optional[torch.Tensor] = None, slots: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13 over the fixed-capacity layout: qslab [nlist, Qcap, dim] against
    values [nlist, C, dim] (row_ids [nlist, C] int32, -1 = empty; scales
    [nlist, C] for int8 cells; qscales [nlist, Qcap] for int8 slots), C a
    multiple of ``block``; ``slots`` int32 [nlist]: each cell's filled slots,
    its first ones (None: every slot), the others' lists (-inf, -1). Returns
    (vals, ids) [nlist * C / block * ceil(block / sel), Qcap, J], ids flat
    positions in [nlist * C]."""
    nlist, C, dim = values.shape
    args = (qslab, values.reshape(nlist * C, dim), row_ids.reshape(-1),
            None if scales is None else scales.reshape(-1), qscales, None, C // block, J, block,
            block if sel is None else sel, slots)
    if not values.is_cuda:
        return _ivf_topj_reference(*args)
    return _launch(cell_topj, *args)


cell_topj.launches = 0
cell_topj.launches_int8 = 0
cell_topj.launches_i8q = 0
cell_topj.launches_generic = 0


def ragged_topj(block_cell: torch.Tensor, qslab: torch.Tensor, values: torch.Tensor,
                row_ids: torch.Tensor, scales: Optional[torch.Tensor], J: int, block: int,
                sel: Optional[int] = None, qscales: Optional[torch.Tensor] = None,
                slots: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14 over the ragged padded-flat layout: values [nb_total * block, dim]
    whose block b belongs to cell ``block_cell[b]`` (int32 [nb_total]); row
    ids, scales, slabs and slots as :func:`cell_topj`. Returns (vals, ids)
    [nb_total * ceil(block / sel), Qcap, J], ids flat positions."""
    args = (qslab, values, row_ids, scales, qscales, block_cell, 1, J, block,
            block if sel is None else sel, slots)
    if not values.is_cuda:
        return _ivf_topj_reference(*args)
    return _launch(ragged_topj, *args)


ragged_topj.launches = 0
ragged_topj.launches_int8 = 0
ragged_topj.launches_i8q = 0
ragged_topj.launches_generic = 0


# -- the searches -----------------------------------------------------------------------------


def _finish(tv, ti, row_ids, ps: ProbeSlab, side, k):
    """Flat positions -> corpus rows, the side scan, the -1 sentinel."""
    doc = row_ids.reshape(-1)[ti.clamp(min=0).long()]
    tv, doc = _side_scan(ps.qc, tv, doc, *side, k, qi=ps.qi, qs=ps.qs)
    return tv, torch.where(tv > NEG_INF / 2, doc, -1)


def _per_query(cv, ci, ps: ProbeSlab, pr, B: int, nprobe: int, k: int):
    """Each pair's candidates (-inf for dropped pairs) back in query order,
    then each query's top-k (steps 4b and 4c)."""
    pv = torch.where(ps.in_cap[:, None], cv[pr], float("-inf"))
    pi = ci[pr]
    inv = torch.empty_like(ps.order)
    inv[ps.order] = torch.arange(ps.order.numel(), device=inv.device)
    kp = cv.shape[1]
    return _top(pv[inv].reshape(B, nprobe * kp), pi[inv].reshape(B, nprobe * kp),
                min(k, nprobe * kp))


def ivf_bulk_search(q, centroids, values, row_ids, scales, side_values, side_scales, side_ids,
                    k: int, nprobe: int, Qcap: int, J: int, block: int, sel: int, nlist: int,
                    hot_penalty=None, side_valid: int = 0, side_J: int = 4,
                    side_block: int = 1024, i8_native: bool = False, n_real=None):
    """Cell-major bulk search over the fixed-capacity layout (ivf_bulk.py:338-440).

    q [B, dim] fp32; values [nlist, C, dim] (fp32 / bf16, or int8 with
    ``scales`` [nlist, C]); row_ids [nlist, C] int32, -1 = empty. ``block``,
    ``sel``, ``J``: the kernel's plan (the index's ``_cell_plan``): storage
    blocks of ``block`` rows, cut into selection blocks of ``sel`` rows that
    keep J <= JMAX each. ``side_*``: the dense side-scan slab (overflow rows
    and hot cells, which ``hot_penalty`` [nlist] (-inf) keeps out of the
    probe), ``side_valid`` real rows. ``n_real``: rows past it are batch
    padding. Returns (scores [B, k], doc_rows [B, k] (-1: no row),
    n_dropped, probe_counts [nlist]), all on the device, with no host sync."""
    B = q.shape[0]
    ps = probe_slab(q, centroids, values.dtype, nlist, nprobe, Qcap, hot_penalty, n_real,
                    i8_native)
    vals_b, ids_b = cell_topj(ps.qslab, values, row_ids, scales, J, block, sel, ps.qscales,
                              filled_slots(ps, Qcap))
    # 4a) per (cell, slot): the cell's selection blocks, in row order
    nbs = vals_b.shape[0] // nlist
    v = vals_b.reshape(nlist, nbs, Qcap, J).permute(0, 2, 1, 3).reshape(nlist * Qcap, nbs * J)
    i = ids_b.reshape(nlist, nbs, Qcap, J).permute(0, 2, 1, 3).reshape(nlist * Qcap, nbs * J)
    cv, ci = _top(v, i, min(k, nbs * J))
    # 4b, 4c) per pair, per query
    pr = torch.where(ps.in_cap, ps.sc * Qcap + ps.slot, 0)
    tv, ti = _per_query(cv, ci, ps, pr, B, nprobe, k)
    tv, doc = _finish(tv, ti, row_ids, ps, (side_values, side_scales, side_ids, side_valid,
                                            side_J, side_block), k)
    return tv, doc, ps.n_dropped, ps.counts


def ivf_ragged_search(q, centroids, values, row_ids, scales, block_cell, block_start,
                      side_values, side_scales, side_ids, k: int, nprobe: int, Qcap: int, J: int,
                      block: int, sel: int, nlist: int, nb_max: int, hot_penalty=None,
                      side_valid: int = 0, side_J: int = 4, side_block: int = 512,
                      i8_native: bool = False, n_real=None):
    """Cell-major bulk search over the ragged layout (ivf_bulk.py:479-564):
    values [nb_total * block, dim] sorted by cell, each cell padded to a
    block multiple; ``block_cell`` [nb_total] each block's cell,
    ``block_start`` [nlist + 1] each cell's block range, ``nb_max`` the most
    blocks of one cell. Otherwise as :func:`ivf_bulk_search`, the kernel's
    plan (``block``, ``sel``, ``J``) included."""
    ps = probe_slab(q, centroids, values.dtype, nlist, nprobe, Qcap, hot_penalty, n_real,
                    i8_native)
    vals_b, ids_b = ragged_topj(block_cell, ps.qslab, values, row_ids, scales, J, block, sel,
                                ps.qscales, filled_slots(ps, Qcap))
    tv, ti = ragged_merge(vals_b, ids_b, ps, block_start, block, sel, nb_max, nprobe, k)
    tv, doc = _finish(tv, ti, row_ids, ps, (side_values, side_scales, side_ids, side_valid,
                                            side_J, side_block), k)
    return tv, doc, ps.n_dropped, ps.counts


def ragged_merge(vals_b, ids_b, ps: ProbeSlab, block_start, block: int, sel: int, nb_max: int,
                 nprobe: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 4a-4c over the ragged layout (ivf_bulk.py:536-556): each pair's
    candidates over the selection blocks of its cell's block range, in row
    order, then per query. Returns (scores [B, k'], flat positions [B, k'])."""
    per = -(-block // sel)
    J = vals_b.shape[2]
    Qcap = vals_b.shape[1]
    nb_total = vals_b.shape[0] // per
    dev = vals_b.device
    prange = block_start[ps.sc].long()[:, None] + torch.arange(nb_max, device=dev)[None, :]
    bvalid = prange < block_start[ps.sc + 1].long()[:, None]
    prs = (prange.clamp(0, nb_total - 1)[:, :, None] * per
           + torch.arange(per, device=dev)).reshape(-1, nb_max * per)
    slot_c = ps.slot.clamp(0, Qcap - 1)[:, None]
    keep = (bvalid & ps.in_cap[:, None]).repeat_interleave(per, dim=1)[:, :, None]
    pv = torch.where(keep, vals_b[prs, slot_c], float("-inf")).reshape(-1, nb_max * per * J)
    pi = ids_b[prs, slot_c].reshape(-1, nb_max * per * J)
    cv, ci = _top(pv, pi, min(k, nb_max * per * J))
    B = ps.qc.shape[0]
    return _per_query(cv, ci, ps, torch.arange(pv.shape[0], device=dev), B, nprobe, k)


def _side_scan(qc, tv, doc, side_values, side_scales, side_ids, side_valid: int, side_J: int,
               side_block: int, k: int, qi=None, qs=None):
    """The dense side-scan slab (ivf_bulk.py:443-476): every query scores its
    ``side_valid`` rows on K8, or K12 with int8 queries over int8 rows; the
    slab's candidates merge at the slab's own k, then with the cells'. Where
    the Poisson J exceeds 32 the slab's block halves, as ``serve_plan``."""
    if side_valid <= 0:
        return tv, doc
    while side_J > JMAX:
        side_block = -(-side_block // 2)
        side_J = serve_j(k, side_block, max(side_block, side_valid))
    if side_scales is not None and qi is not None:
        sv_b, si_b = block_topj_i8q(qi, qs, side_values, side_scales, side_J, side_block,
                                    side_valid)
    else:
        sv_b, si_b = block_topj_serve(qc, side_values, side_J, side_block, side_valid,
                                      side_scales)
    B = qc.shape[0]
    flat_v, flat_i = sv_b.reshape(B, -1), si_b.reshape(B, -1)
    so_top, so_rows = _top(flat_v, flat_i, min(k, flat_v.shape[1], side_valid))
    so_doc = side_ids[so_rows.clamp(min=0).long()]
    all_v, all_d = torch.cat([tv, so_top], 1), torch.cat([doc, so_doc.to(doc.dtype)], 1)
    return _top(all_v, all_d, min(k, all_v.shape[1]))
